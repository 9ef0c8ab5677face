"""Training step: clip loss, parameter groups, LR schedule, AdamW
(counterpart of ``memotr_tpu/engine/trainer.py``).

- **Parameter groups**: backbone (``LR_BACKBONE``), the reference-point and
  sampling-offset heads (``LR_POINTS``), the query updater (``LR``) and the
  rest (``LR``).  The ResNet stem and ``layer1`` are frozen: their
  parameters have ``requires_grad=False`` (``models/resnet.py``) and no
  group.  After ``ONLY_TRAIN_QUERY_UPDATER_AFTER`` epochs every group but
  the query updater gets LR 0.
- **Optimizer**: grads clipped to ``CLIP_MAX_NORM`` over the trainable
  parameters, then ``torch.optim.AdamW`` (betas 0.9/0.999, eps 1e-8,
  ``WEIGHT_DECAY``) with each group's LR.  Gradient accumulation sums the
  micro-batch gradients of losses divided by ``ACCUMULATION_STEPS``.
- **Loss**: per-frame weighted focal / L1 / GIoU (+ aux) losses summed over
  the clip and divided by the clip's GT count.
- **Clip loop**: frames run in order in one graph, so gradients cross
  frames through the track state; the first ``NO_GRAD_FRAMES`` frames run
  under ``torch.no_grad()``; the last frame skips the track selection and
  the query updater.

``Trainer`` is the entry: it takes a collated clip batch
(``data/loader.collate_clips``), runs on the GPU unless asked for the CPU,
and takes one optimizer step per ``ACCUMULATION_STEPS`` micro-batches of
an epoch, counting warmup per micro-batch as the JAX loop does.  The JAX
package's ``lax.scan`` formulation of the clip loop (``TRAIN_FRAME_SCAN``)
is not ported: the unrolled loop is the same computation.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import cfg_get
from ..models.criterion import ClipCriterion, FrameGT, build_criterion
from ..models.frame_step import train_frame_step
from ..structures.track_state import TrackState
from .submit import resolve_device

LOSS_WEIGHT_KEYS = ("label_focal_loss", "box_l1_loss", "box_giou_loss")
GROUPS = ("backbone", "points", "query_updater", "base")


# --------------------------------------------------------------- param groups
def param_group_label(name: str) -> str:
    """A parameter's LR group from its name (the reference names the port
    uses): the JAX package's ``param_group_label`` over torch names."""
    if name.startswith("backbone."):
        rest = name.split("backbone.backbone.backbone.", 1)[-1]
        if rest.startswith(("conv1.", "bn1.", "layer1.")):
            return "frozen"
        return "backbone"
    if "reference_points" in name or "sampling_offsets" in name:
        return "points"
    if name.startswith("query_updater."):
        return "query_updater"
    return "base"


def param_groups(model: nn.Module) -> Dict[str, List[nn.Parameter]]:
    """The trainable parameters by group (frozen ones are left out)."""
    groups: Dict[str, List[nn.Parameter]] = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        label = param_group_label(name)
        if label == "frozen" or not p.requires_grad:
            assert label == "frozen" and not p.requires_grad, \
                f"{name}: label {label}, requires_grad {p.requires_grad}"
            continue
        groups[label].append(p)
    return groups


def lr_schedule_factory(config: dict) -> Callable[[int], float]:
    """Per-epoch LR multiplier."""
    kind = cfg_get(config, "LR_SCHEDULER")
    if kind == "MultiStep":
        milestones = list(cfg_get(config, "LR_DROP_MILESTONES"))
        gamma = cfg_get(config, "LR_DROP_RATE")

        def schedule(epoch: int) -> float:
            return gamma ** sum(1 for m in milestones if epoch >= m)
    elif kind == "Cosine":
        t_max = cfg_get(config, "EPOCHS")

        def schedule(epoch: int) -> float:
            return 0.5 * (1 + math.cos(math.pi * epoch / t_max))
    else:
        raise ValueError(f"Unknown LR scheduler '{kind}'")
    return schedule


def warmup_scale(global_iter: int, warmup_iters: int) -> float:
    """Linear LR warmup multiplier (``WARMUP_ITERS``; 0 = off)."""
    if warmup_iters <= 0 or global_iter >= warmup_iters:
        return 1.0
    return (global_iter + 1) / warmup_iters


def group_lrs(config: dict, epoch: int) -> Dict[str, float]:
    """Each group's LR for this epoch, with the updater-only freeze."""
    mult = lr_schedule_factory(config)(epoch)
    lr = cfg_get(config, "LR") * mult
    lrs = {"backbone": cfg_get(config, "LR_BACKBONE") * mult,
           "points": cfg_get(config, "LR_POINTS") * mult,
           "query_updater": lr, "base": lr, "frozen": 0.0}
    if epoch >= cfg_get(config, "ONLY_TRAIN_QUERY_UPDATER_AFTER", 10 ** 9):
        lrs["backbone"] = lrs["points"] = lrs["base"] = 0.0
    return lrs


def no_grad_frames_for_epoch(config: dict, epoch: int) -> Optional[int]:
    """The ``NO_GRAD_FRAMES`` schedule: ``NO_GRAD_STEPS`` is a descending
    list of epoch thresholds; the first one the epoch has reached picks the
    matching ``NO_GRAD_FRAMES`` entry."""
    steps = config.get("NO_GRAD_STEPS")
    frames = config.get("NO_GRAD_FRAMES")
    if not steps or frames is None:
        return frames if isinstance(frames, int) else None
    if isinstance(frames, int):
        frames = [frames] * len(steps)
    for i, s in enumerate(steps):
        if epoch >= s:
            return frames[i]
    return None


def make_optimizer(groups: Dict[str, List[nn.Parameter]],
                   config: dict) -> torch.optim.AdamW:
    """AdamW over the groups (each group's LR is set per step).

    The JAX package's optax chain is clip -> scale_by_adam(0.9, 0.999,
    1e-8) -> add_decayed_weights(wd) -> times -lr per group, which updates
    p - lr*wd*p - lr*m_hat/(sqrt(v_hat)+eps).  AdamW's decoupled decay
    followed by its Adam step gives exactly that, both on the old p; the
    clipping happens before ``step`` (``clip_grad_norm_``)."""
    return torch.optim.AdamW(
        [{"params": ps, "name": g, "lr": 0.0} for g, ps in groups.items()
         if ps],
        lr=0.0, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=cfg_get(config, "WEIGHT_DECAY"))


def set_lrs(optimizer: torch.optim.Optimizer, lrs: Dict[str, float]) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lrs[group["name"]]


# ------------------------------------------------------------------ clip loss
def static_config(config: dict, model, world_size: int = 1) -> Dict:
    no_grad = cfg_get(config, "NO_GRAD_FRAMES")
    return {
        "track_slots": cfg_get(config, "TRACK_SLOTS"),
        "hidden_dim": config["HIDDEN_DIM"],
        "num_classes": model.num_classes,
        "use_dab": cfg_get(config, "USE_DAB"),
        "update_threshold": cfg_get(config, "UPDATE_THRESH", 0.5),
        "tp_drop_ratio": cfg_get(config, "TP_DROP_RATE"),
        "fp_insert_ratio": cfg_get(config, "FP_INSERT_RATE"),
        "no_grad_frames": 0 if no_grad is None else no_grad,
        "frame_weight": 1.0,
        "world_size": world_size,
        "loss_weights": {
            "label_focal_loss": cfg_get(config, "LOSS_WEIGHT_FOCAL"),
            "box_l1_loss": cfg_get(config, "LOSS_WEIGHT_L1"),
            "box_giou_loss": cfg_get(config, "LOSS_WEIGHT_GIOU"),
        },
    }


def clip_loss(model, criterion: ClipCriterion, batch: Dict[str, torch.Tensor],
              generator: torch.Generator, cs: Dict
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss over one clip batch: images (B, T, H, W, 3) normalized, mask
    (B, T, H, W), gt_* (B, T, G, ...), all on the model's device.
    Returns (total loss, logs)."""
    images = batch["images"]
    b, t = images.shape[:2]
    state = TrackState.empty(b, cs["track_slots"], cs["hidden_dim"],
                             cs["num_classes"], use_dab=cs["use_dab"],
                             device=images.device)
    loss_acc: Dict[str, torch.Tensor] = {}
    frame_logs: Dict[str, torch.Tensor] = {}
    n_gts_total = torch.zeros((), device=images.device)
    world = cs["world_size"]
    k = cs["no_grad_frames"]
    for f in range(t):
        gt = FrameGT(boxes=batch["gt_boxes"][:, f],
                     labels=batch["gt_labels"][:, f],
                     ids=batch["gt_ids"][:, f], mask=batch["gt_mask"][:, f])
        with torch.set_grad_enabled(f >= k and torch.is_grad_enabled()):
            losses, n_gts, state = train_frame_step(
                model, criterion, images[:, f], batch["mask"][:, f], gt,
                state, generator, cs["update_threshold"], cs["tp_drop_ratio"],
                cs["fp_insert_ratio"], no_augment=f < k - 1,
                postprocess=f < t - 1)
        for name, v in losses.items():
            loss_acc[name] = loss_acc.get(name, 0.0) + v * cs["frame_weight"]
        frame_gts = n_gts.sum().float()
        n_gts_total = n_gts_total + frame_gts
        frame_norm = (frame_gts / world).clamp(min=1.0) * world
        for name in ("box_l1_loss", "box_giou_loss", "label_focal_loss"):
            if name in losses:
                frame_logs[f"frame{f}_{name}"] = losses[name].detach() \
                    / frame_norm

    normalizer = (n_gts_total / world).clamp(min=1.0) * world
    weights = cs["loss_weights"]

    def w_for(name):
        for key in LOSS_WEIGHT_KEYS:
            if key in name:
                return weights[key]
        return 1.0

    total = sum(w_for(name) * v for name, v in loss_acc.items()) / normalizer
    logs = {name: v.detach() / normalizer for name, v in loss_acc.items()}
    logs.update(frame_logs)
    logs["total_loss"] = total.detach()
    logs["n_gts"] = n_gts_total
    return total, logs


def _fill_missing_grads(params: List[nn.Parameter]) -> int:
    """Zero gradients for trainable parameters the loss did not reach (the
    query updater of a one-frame clip): the JAX gradient is zeros there, and
    AdamW still decays such a parameter.  Returns how many there were."""
    missing = [p for p in params if p.grad is None]
    for p in missing:
        p.grad = torch.zeros_like(p)
    return len(missing)


def make_train_step(model, criterion: ClipCriterion,
                    optimizer: torch.optim.Optimizer, config_static: Dict,
                    clip_max_norm: float):
    """step(batch, generator, lrs) -> logs: the clip loss, its gradient,
    clipping and one AdamW step.  ``logs["grad_norm"]`` is the global norm
    of the trainable parameters' gradients before clipping;
    ``logs["params_without_grad"]`` counts the trainable parameters the
    loss did not reach."""
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(batch, generator, lrs):
        set_lrs(optimizer, lrs)
        optimizer.zero_grad(set_to_none=True)
        total, logs = clip_loss(model, criterion, batch, generator,
                                config_static)
        total.backward()
        logs["params_without_grad"] = _fill_missing_grads(params)
        logs["grad_norm"] = torch.nn.utils.clip_grad_norm_(params,
                                                           clip_max_norm)
        optimizer.step()
        return logs

    return step


def make_accum_steps(model, criterion: ClipCriterion,
                     optimizer: torch.optim.Optimizer, config_static: Dict,
                     clip_max_norm: float, accumulation: int):
    """Gradient accumulation: (grad_step, apply_step).
    ``grad_step(batch, generator) -> logs`` adds the gradient of the clip
    loss / ``accumulation`` to the parameters' ``.grad``;
    ``apply_step(lrs) -> grad_norm`` clips the summed gradient, takes one
    AdamW step and clears the gradients."""
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def grad_step(batch, generator):
        total, logs = clip_loss(model, criterion, batch, generator,
                                config_static)
        (total / accumulation).backward()
        return logs

    def apply_step(lrs):
        set_lrs(optimizer, lrs)
        _fill_missing_grads(params)
        grad_norm = torch.nn.utils.clip_grad_norm_(params, clip_max_norm)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return grad_norm

    return grad_step, apply_step


BATCH_KEYS = ("images", "mask", "gt_boxes", "gt_ids", "gt_labels", "gt_mask")


class Trainer:
    """The training entry: one collated clip batch per ``step`` call.

    ``model``: a ``build_model`` model (float32 parameters, ``DTYPE``
    compute), moved to ``device`` and put in training mode.  Runs on the GPU
    unless ``device="cpu"``; raises when CUDA is asked for and absent.  The
    track-selection draws come from a generator seeded with ``seed``.
    ``train_step`` and ``grad_step`` / ``apply_step`` are the functions of
    ``make_train_step`` and ``make_accum_steps`` on this model."""

    def __init__(self, model, config: dict, device: torch.device | str = "cuda",
                 seed: int = 0, world_size: int = 1):
        self.device = resolve_device(device)
        self.model = model.to(self.device).train()
        self.config = config
        self.criterion = build_criterion(config)
        self.config_static = static_config(config, model, world_size)
        self.optimizer = make_optimizer(param_groups(model), config)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.accumulation = int(cfg_get(config, "ACCUMULATION_STEPS"))
        clip = cfg_get(config, "CLIP_MAX_NORM")
        self.train_step = make_train_step(model, self.criterion, self.optimizer,
                                     self.config_static, clip)
        self.grad_step, self.apply_step = make_accum_steps(
            model, self.criterion, self.optimizer, self.config_static, clip,
            self.accumulation)
        # counted as the JAX loop counts them (memotr_tpu/engine/train.py):
        # ``global_iter`` once per micro-batch, ``micro_steps`` within the
        # current ``epoch``
        self.micro_steps = 0
        self.global_iter = 0
        self.epoch: Optional[int] = None

    def batch_to_device(self, batch: Dict[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(batch[k]).to(self.device)
                for k in BATCH_KEYS}

    def lrs(self, epoch: int) -> Dict[str, float]:
        """Each group's LR at the current micro-batch: the epoch's LR times
        the warmup factor of ``global_iter``."""
        scale = warmup_scale(self.global_iter,
                             int(cfg_get(self.config, "WARMUP_ITERS")))
        return {k: v * scale for k, v in group_lrs(self.config,
                                                   epoch).items()}

    def step(self, batch: Dict[str, np.ndarray], epoch: int = 0
             ) -> Dict[str, torch.Tensor]:
        """One micro-batch; an optimizer step on every ``ACCUMULATION_STEPS``-th
        micro-batch of an epoch (``logs["grad_norm"]`` is present on those
        calls), at the LR of the micro-batch that applies it.  A new
        ``epoch`` drops the gradients of the previous epoch's leftover
        micro-batches and restarts the count."""
        if epoch != self.epoch:
            self.epoch = epoch
            self.micro_steps = 0
            self.optimizer.zero_grad(set_to_none=True)
        self.config_static["no_grad_frames"] = \
            no_grad_frames_for_epoch(self.config, epoch) or 0
        batch = self.batch_to_device(batch)
        if self.accumulation == 1:
            logs = self.train_step(batch, self.generator, self.lrs(epoch))
        else:
            logs = self.grad_step(batch, self.generator)
            self.micro_steps += 1
            if self.micro_steps % self.accumulation == 0:
                logs["grad_norm"] = self.apply_step(self.lrs(epoch))
        self.global_iter += 1
        return logs
