"""Training entry point (counterpart of ``memotr_tpu/engine/train.py``).

``train(config)``: the logger and the resolved ``config.yaml`` (which
``submit()`` reads back), seeding, the model and its pretrained weights,
the distillation teacher (``DISTILL_TEACHER``, ``load_teacher``), the
dataset and the threaded loader, one ``Trainer``, ``RESUME``, then the
epoch loop (curriculum, LR schedule, accumulation and warmup as the
``Trainer`` counts them) with the reference's checkpoint policy.  Runs on
the GPU unless ``device="cpu"``; never falls back to the CPU.
``VISUALIZE`` dumps each iteration's per-frame decoder outputs and track
state into ``OUTPUTS_DIR/visualize_train/frame_<global iter>.npz``.

In a process group (``main.py --multi-host`` under torchrun, or a group
the caller started) each process trains on one device: it seeds with
``SEED + rank``, loads its ``rank::world`` share of each epoch's clips
(``BATCH_SIZE`` a process), and its ``Trainer`` reduces GT counts,
gradients and loss logs over the group (``engine/trainer.py``).  Rank 0
alone writes the logs, the checkpoints and the dumps; every rank returns
once the last checkpoint is written.

Not ported, and refused: the TPU mesh keys (``MESH_DEVICES``,
``MESH_SEQ_DEVICES`` above 1, ``TOKEN_SHARD_AXIS``): one process runs on
one device.
"""
from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from ..checkpoint.files import (host_rng_state, load_checkpoint,
                                remap_pretrained_dab, save_checkpoint,
                                set_host_rng_state)
from ..config import (cfg_get, dict_to_yaml, missing_train_keys,
                      yaml_to_dict)
from ..data import build_dataloader, build_dataset
from ..log.logger import Logger, MetricLog
from ..models.memotr import build_model
from ..utils import distributed
from ..utils.debug_dump import DebugDumper
from ..utils.misc import set_seed
from .submit import check_options, resolve_device
from .trainer import Trainer, group_lrs

# the decoder's aliases of the output heads (the reference shares them);
# counted, like the JAX package's converter does, under the heads' names
_HEAD_ALIAS = re.compile(r"^transformer\.decoder\.(bbox_embed|class_embed)\.")


def _units(name: str) -> int:
    """A tensor's count in the JAX package's parameter leaves, so that the
    merge counts read the same in both logs: a joint attention projection
    is three (q, k, v)."""
    return 3 if name.endswith(("in_proj_weight", "in_proj_bias")) else 1


def check_train_options(config: dict) -> None:
    """Raise on a config the JAX package's ``train`` refuses: one that
    lacks a key it reads as ``config[key]`` (``config.TRAIN_REQUIRED``);
    and on the options not ported."""
    missing = missing_train_keys(config)
    if missing:
        raise KeyError(f"the training config lacks {', '.join(missing)}")
    check_options(config)
    if cfg_get(config, "TOKEN_SHARD_AXIS"):
        raise NotImplementedError("TOKEN_SHARD_AXIS (token sequence "
                                  "parallelism) is TPU-only and not ported")


def load_pretrained(config: dict, model: torch.nn.Module, logger: Logger
                    ) -> Optional[Dict[str, int]]:
    """Loads ``PRETRAINED_MODEL`` into ``model`` where names and shapes
    match (strict=False), and returns the counts it prints (None when
    there is no file).

    Two kinds of file: a reference-format ``.pth`` (a DAB-Deformable-DETR
    pretrain or a MeMOTR checkpoint), remapped by ``remap_pretrained_dab``;
    or an epoch checkpoint of the port (it has ``"states"``), a transplant
    of its model as it is.  Unless ``PRETRAIN_SKIP_ENCODER`` says
    otherwise, the encoder's tensors (``transformer.encoder.*``) are
    skipped when ``ENCODER_TYPE`` is not deformable: several names collide
    across encoder families with matching shapes, and a silent partial
    load would be wrong.  The counts are in the JAX package's units
    (``_units``; a head alias counted once), so they equal its
    ``load_pretrained``'s for the same file."""
    path = config.get("PRETRAINED_MODEL")
    if not path or not os.path.exists(path):
        if path:
            logger.show(head=f"[warn] PRETRAINED_MODEL {path} not found; "
                             f"training from scratch.")
        return None
    if os.path.isdir(path):
        raise ValueError(f"PRETRAINED_MODEL {path} is a directory: the port "
                         f"reads torch checkpoint files (a JAX Orbax "
                         f"checkpoint converts with state_dict_from_jax)")
    skip_encoder = cfg_get(config, "PRETRAIN_SKIP_ENCODER")
    if skip_encoder is None:
        skip_encoder = cfg_get(config, "ENCODER_TYPE") != "deformable"
    ckpt = load_checkpoint(path)
    if "states" in ckpt:
        sd = ckpt["model"]
        logger.show(head=f"Transplanting port checkpoint {path} "
                         f"(skip_encoder={skip_encoder}).")
    else:
        sd = remap_pretrained_dab(ckpt.get("model", ckpt), model.num_classes)
        logger.show(head=f"Pretrained {path} loaded "
                         f"(skip_encoder={skip_encoder}).")
    sd = {_HEAD_ALIAS.sub(r"\1.", k): v for k, v in sd.items()}
    target = model.state_dict()
    stats = {"loaded": 0, "shape_mismatch": 0, "encoder_skipped": 0}
    merged = {}
    for k, v in sd.items():
        if skip_encoder and k.startswith("transformer.encoder."):
            stats["encoder_skipped"] += _units(k)
        elif k not in target:
            continue          # absent from this model: dropped (strict=False)
        elif target[k].shape == v.shape:
            merged[k] = v
            stats["loaded"] += _units(k)
        else:
            stats["shape_mismatch"] += _units(k)
    model.load_state_dict(merged, strict=False)
    logger.show(head=f"Pretrain merge: {stats['loaded']} tensors loaded, "
                     f"{stats['shape_mismatch']} shape-mismatched, "
                     f"{stats['encoder_skipped']} encoder leaves skipped.")
    return stats


def load_teacher(config: dict, logger: Logger) -> Optional[Dict]:
    """The distillation teacher of ``DISTILL_TEACHER`` (None when unset):
    ``{"model", "weights"}`` as ``Trainer`` takes it.

    The file is an epoch checkpoint of the port (``.pth`` with
    ``"states"``), loaded strictly into ``build_model`` of the teacher's
    own config, ``train/config.yaml`` beside it; the teacher must share
    ``HIDDEN_DIM`` and ``NUM_DET_QUERIES`` with the student.  The weights
    are ``DISTILL_WEIGHT_MEMORY`` / ``_LOGIT`` / ``_BOX``."""
    path = cfg_get(config, "DISTILL_TEACHER")
    if not path:
        return None
    if os.path.isdir(path):
        raise ValueError(f"DISTILL_TEACHER {path} is a directory: the port "
                         f"reads its own epoch checkpoints (.pth; a JAX "
                         f"Orbax checkpoint converts with state_dict_from_jax)")
    t_config = yaml_to_dict(os.path.join(
        os.path.dirname(os.path.abspath(path)), "train", "config.yaml"))
    for key in ("HIDDEN_DIM", "NUM_DET_QUERIES"):
        if t_config[key] != config[key]:
            raise ValueError(f"distillation teacher {path} has {key} "
                             f"{t_config[key]}, the student {config[key]}")
    ckpt = load_checkpoint(path)
    if "states" not in ckpt:
        raise ValueError(f"DISTILL_TEACHER {path} is not an epoch checkpoint "
                         f"of the port (no 'states')")
    teacher = build_model(t_config)
    teacher.load_state_dict(ckpt["model"])
    weights = {f"distill_{k}": float(cfg_get(config,
                                             f"DISTILL_WEIGHT_{k.upper()}"))
               for k in ("memory", "logit", "box")}
    logger.show(head=f"Distillation: teacher={path} "
                     f"({cfg_get(t_config, 'ENCODER_TYPE')} encoder), "
                     f"weights={weights}")
    return {"model": teacher, "weights": weights}


@dataclass
class TrainRun:
    """What ``train`` returns: the trainer (model, optimizer and, as
    ``trainer.distill``, the distillation teacher), the
    progress ``states``, the pretrain-merge counts, and per iteration the
    seconds the loop waited for the loader and the seconds of the step
    (from the batch's arrival to its logs on the host)."""
    trainer: Trainer
    states: Dict[str, int]
    pretrain: Optional[Dict[str, int]] = None
    wait_seconds: List[float] = field(default_factory=list)
    step_seconds: List[float] = field(default_factory=list)


def _host_logs(logs: Dict, device: torch.device) -> Dict[str, float]:
    """The step's logs as floats, with one device-to-host copy."""
    vals = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=device)
                        .detach().reshape(()) for v in logs.values()])
    return dict(zip(logs, vals.tolist()))


def train(config: dict, device: torch.device | str = "cuda") -> TrainRun:
    check_train_options(config)
    device = resolve_device(device)
    rank, world = distributed.rank_and_world()
    logger = Logger(logdir=os.path.join(config["OUTPUTS_DIR"], "train"))
    logger.show(head="Configs:", log=config)
    if logger.enabled:
        dict_to_yaml(config, os.path.join(logger.logdir, "config.yaml"))
    seed = set_seed(config["SEED"], rank)

    model = build_model(config)
    pretrain = load_pretrained(config, model, logger)
    distill = load_teacher(config, logger)

    dataset = build_dataset(config, split="train")
    dataloader = build_dataloader(dataset, config, shuffle=True, rank=rank,
                                  world_size=world)
    logger.show(head="Frame decode:", log="PIL (training clips are decoded "
                "and augmented on the host by PIL and cv2)")
    if world > 1:
        logger.show(head=f"Data parallel: {world} processes, one device "
                         f"each, {config['BATCH_SIZE']} clips a process")
    trainer = Trainer(model, config, device, seed=seed, distill=distill)

    states = {"start_epoch": 0, "global_iters": 0}
    if config.get("RESUME"):
        ckpt = load_checkpoint(config["RESUME"])
        model.load_state_dict(ckpt["model"])
        trainer.optimizer.load_state_dict(ckpt["optimizer"])
        states.update(ckpt["states"])
        trainer.global_iter = states["global_iters"]
        if "rng" in ckpt:
            set_host_rng_state(ckpt["rng"], trainer.generator)
        logger.show(head=f"Resumed {config['RESUME']}: {states}")

    run = TrainRun(trainer, states, pretrain)
    train_dumper = DebugDumper(
        os.path.join(config["OUTPUTS_DIR"], "visualize_train"),
        bool(cfg_get(config, "VISUALIZE")) and logger.enabled)
    multi_checkpoint = bool(cfg_get(config, "MULTI_CHECKPOINT")) \
        and logger.enabled
    for epoch in range(states["start_epoch"], config["EPOCHS"]):
        dataloader.set_epoch(epoch)
        logger.show(head=f"[Epoch {epoch}] lrs={group_lrs(config, epoch)}")
        metric_log = MetricLog()
        epoch_t0 = time.time()
        t0 = time.perf_counter()
        for i, batch in enumerate(dataloader):
            it_t0 = time.perf_counter()
            gt_dropped = int(batch.pop("gt_dropped", 0))
            if gt_dropped:
                metric_log.update("gt_dropped", gt_dropped)
                logger.show(head=f"[Epoch={epoch}, Iter={i}] WARNING:",
                            log=f"{gt_dropped} GT boxes truncated "
                                f"(MAX_GTS too small for this batch)")
            logs = trainer.step(batch, epoch)
            debug = logs.pop("debug", None)
            if debug is not None:
                train_dumper.dump_frame(states["global_iters"], results=debug)
            logs = _host_logs(logs, device)
            for k, v in logs.items():
                metric_log.update(k, v)
            run.wait_seconds.append(it_t0 - t0)
            run.step_seconds.append(time.perf_counter() - it_t0)
            metric_log.update("time per iter", run.step_seconds[-1])
            metric_log.update("data wait", run.wait_seconds[-1])
            if i % 100 == 0:
                metric_log.sync()
                spi = metric_log.metrics["time per iter"].avg
                logger.show(
                    head=f"[Epoch={epoch}, Iter={i}/{len(dataloader)}, "
                         f"{spi:.2f}s/iter]", log=metric_log)
                logger.metric_log(metric_log, states["global_iters"])
            if multi_checkpoint and i % 100 == 0:
                save_checkpoint(os.path.join(config["OUTPUTS_DIR"],
                                             f"checkpoint_iter{i // 100}.pth"),
                                model)
            states["global_iters"] += 1
            t0 = time.perf_counter()

        states["start_epoch"] = epoch + 1
        logger.show(head=f"[Epoch {epoch}] total "
                         f"{int((time.time() - epoch_t0) // 60)} min",
                    log=metric_log)
        # the reference's checkpoint policy (train_engine.py:146-153)
        if logger.enabled and (config["DATASET"] == "DanceTrack"
                               or config["EPOCHS"] < 100
                               or (epoch + 1) % 5 == 0):
            save_checkpoint(
                os.path.join(config["OUTPUTS_DIR"], f"checkpoint_{epoch}.pth"),
                model, trainer.optimizer, states,
                host_rng_state(trainer.generator))
    distributed.barrier()
    return run
