"""Inputs of a run, made from ``--seed``: the model's weights and the
streamed frames.

Everything is drawn on the run's device from one ``torch.Generator`` in a
few large calls, then handed to the program (and, after the window, to the
reference) as plain tensors and arrays.  The seed changes what the frames
show, never their sizes or counts: every seed gives the same
work.

The generators are frozen copies, reworked to draw on the device, of
``chip_smoke.py``'s ``scaled_weights_`` and ``synthetic_frames``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SEED_MOD = 2 ** 63 - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one input stream (weights 0, frames 1, ...)
    of a seed; any whole number is a seed."""
    return torch.Generator(device).manual_seed(
        (int(seed) * 1000003 + stream) % SEED_MOD)


# ------------------------------------------------------------------ weights
def _norm_weights(model: nn.Module) -> List[str]:
    return [f"{name}.weight" if name else "weight"
            for name, mod in model.named_modules()
            if isinstance(mod, (nn.LayerNorm, nn.GroupNorm))]


def make_weights(model: nn.Module, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """A state dict for ``model``'s names and shapes, in float32 on
    ``device`` (``scaled_weights_``): each weight matrix or kernel at std
    1/sqrt(fan_in), the scale at which activations and gradients keep
    their size through depth; vectors at std 0.02; norms' scales around
    one; unit-scale DAB detection queries and anchors; buffers (frozen
    batch norms) with running variances in [0.5, 1.5) and the rest at std
    0.3 (scales around one)."""
    g = generator(seed, 0, device)
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    draw = torch.randn(sum(p.numel() for p in params.values()),
                       generator=g, device=device)
    unit = torch.rand(sum(b.numel() for b in buffers.values()), generator=g,
                      device=device)
    bdraw = torch.randn(unit.numel(), generator=g, device=device)
    norms = set(_norm_weights(model))
    out: Dict[str, torch.Tensor] = {}
    start = 0
    for name, p in params.items():
        chunk = draw[start:start + p.numel()].view(p.shape)
        start += p.numel()
        if name in ("det_query_embed", "det_anchor"):
            std = 1.0
        else:
            std = p[0].numel() ** -0.5 if p.dim() >= 2 else 0.02
        out[name] = chunk * std + (1.0 if name in norms else 0.0)
    start = 0
    for name, b in buffers.items():
        n = b.numel()
        if "running_var" in name:
            out[name] = (unit[start:start + n] + 0.5).view(b.shape)
        else:
            out[name] = (bdraw[start:start + n] * 0.3
                         + (1.0 if "weight" in name else 0.0)).view(b.shape)
        start += n
    # a module shared under two names (the box heads) has one draw
    by_id = {id(t): name for name, t in dict(params, **buffers).items()}
    return {k: out[by_id[id(t)]].to(t.dtype)
            for k, t in model.state_dict(keep_vars=True).items()}


@torch.no_grad()
def calibrate_detections(weights: Dict[str, torch.Tensor], config: dict,
                         image: np.ndarray, mask: np.ndarray, k: int,
                         device) -> None:
    """Shift every class head's bias (in place) so that ``k`` detection
    queries score over ``DET_SCORE_THRESH`` on ``image``, a (H, W, 3)
    uint8 frame, with no live track: seeded random weights otherwise put
    every query or none over it, a trained model some tens.  The plain
    reference (float32, TF32 off) computes the scores, so the program
    only ever sees the finished weights."""
    import math

    from .reference import build, no_tf32
    from .reference.structures.track_state import TrackState
    with torch.device(device):
        ref = build(config)
    ref.load_state_dict(weights)
    ref.eval()
    img = normalize_uint8(torch.as_tensor(image, device=device)[None])
    msk = torch.as_tensor(mask, device=device)[None]
    st = TrackState.empty(1, config["TRACK_SLOTS"], config["HIDDEN_DIM"],
                          ref.num_classes, device=device)
    with no_tf32():
        out = ref(img, msk, st.query_embed, st.ref_pts, st.mask)
    det = out["pred_logits"][0, :config["NUM_DET_QUERIES"]].amax(-1)
    top = torch.sort(det, descending=True).values
    thresh = config["DET_SCORE_THRESH"]
    cut = 0.5 * float(top[k - 1] + top[k]) - math.log(thresh / (1 - thresh))
    for name, v in weights.items():
        if name.startswith("class_embed.") and name.endswith(".bias"):
            v.sub_(cut)


# ---------------------------------------------------------------- geometry
def resized_hw(ori_hw, short_side: int, max_side: int):
    """The size ``SeqDataset`` resizes a frame of ``ori_hw`` to."""
    h, w = ori_hw
    scale = short_side / min(h, w)
    if max(h, w) * scale > max_side:
        scale = max_side / max(h, w)
    return int(h * scale), int(w * scale)


def _boxes(g, n: int, hw, size_lo, size_hi, speed, device):
    """Sizes (n, 2) as (w, h) in pixels, positions and velocities."""
    h, w = hw
    lo = torch.tensor(size_lo, device=device)
    hi = torch.tensor(size_hi, device=device)
    size = (lo + (hi - lo) * torch.rand((n, 2), generator=g, device=device)) \
        * torch.tensor([w, h], device=device)
    size = size.floor()
    room = torch.tensor([w, h], device=device) - size
    pos = torch.rand((n, 2), generator=g, device=device) * room
    vel = (torch.rand((n, 2), generator=g, device=device) * 2 - 1) * speed
    return size, pos, vel, room


def _paint(img, tex, pos):
    """Paste each object's texture at its position (in place)."""
    for i, t in enumerate(tex):
        x, y = int(pos[i, 0]), int(pos[i, 1])
        img[y:y + t.shape[0], x:x + t.shape[1]] = t


def _move(pos, vel, room):
    pos = torch.minimum(torch.maximum(pos + vel, torch.zeros_like(pos)), room)
    vel = torch.where((pos <= 0) | (pos >= room), -vel, vel)
    return pos, vel


def stream_lanes(seed: int, device, lanes: int, ring: int, ori_hw, canvas,
                 short_side: int, max_side: int, objects: int,
                 size_lo, size_hi, speed: float) -> Dict:
    """``lanes`` rings of ``ring`` uint8 frames each, as ``SeqDataset``
    gives them: the ``ori_hw`` source frame resized to its valid size at
    the top left of the ``canvas``, the rest zero and masked.  Each lane
    shows ``objects`` textured boxes moving over a textured background.
    Returns host arrays: images (lanes, ring, H, W, 3) uint8, mask (H, W)
    bool, and the valid size."""
    g = generator(seed, 1, device)
    vh, vw = resized_hw(ori_hw, short_side, max_side)
    ch, cw = canvas
    if vh > ch or vw > cw:
        raise ValueError(f"valid {vh}x{vw} exceeds the canvas {ch}x{cw}")
    frames = torch.zeros((lanes, ring, ch, cw, 3), dtype=torch.uint8,
                         device=device)
    bgs = torch.randint(40, 140, (lanes, vh, vw, 3), generator=g,
                        device=device, dtype=torch.uint8)
    for lane in range(lanes):
        size, pos, vel, room = _boxes(g, objects, (vh, vw), size_lo, size_hi,
                                      speed, device)
        tex = [torch.randint(100, 255, (int(s[1]), int(s[0]), 3),
                             generator=g, device=device, dtype=torch.uint8)
               for s in size]
        size_h, pos_h, vel_h, room_h = (t.cpu() for t in (size, pos, vel,
                                                          room))
        for f in range(ring):
            img = bgs[lane].clone()
            _paint(img, tex, pos_h)
            frames[lane, f, :vh, :vw] = img
            pos_h, vel_h = _move(pos_h, vel_h, room_h)
    mask = np.ones((ch, cw), bool)
    mask[:vh, :vw] = False
    return {"images": frames.cpu().numpy(), "mask": mask,
            "valid": (vh, vw)}


def ring_index(i: int, ring: int) -> int:
    """Frame ``i`` of a ring played forward and back (0, 1, .., R-1, R-2,
    .., 1, 0, 1, ...), so that objects move on without a jump."""
    if ring == 1:
        return 0
    r = i % (2 * ring - 2)
    return r if r < ring else 2 * ring - 2 - r


class Lane:
    """One endless lane as an indexable sequence of ``length`` frame dicts
    (``{"image", "mask", "ori_hw", "path"}``, as ``SeqDataset`` gives
    them) over a ring of pre-made frames."""

    def __init__(self, ring: np.ndarray, mask: np.ndarray, ori_hw,
                 length: int):
        self.ring, self.mask, self.ori_hw = ring, mask, tuple(ori_hw)
        self.length = length

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int) -> Dict:
        return {"image": self.ring[ring_index(i, len(self.ring))],
                "mask": self.mask, "ori_hw": self.ori_hw,
                "path": f"{i + 1:08d}.jpg"}


def normalize_uint8(images: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization of (B, H, W, 3) uint8 frames, in float32."""
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    return (images.float() / 255.0 - mean) / std
