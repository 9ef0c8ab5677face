"""Operations and bytes: the table of peaks, the kernels' least times from
their shapes, and the model's FLOPs a frame.

Peaks are those of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its
700 W limit).  A kernel's least time is the larger of its bytes over the
HBM rate (each input read once, each output written once) and its
operations over the peak of the arithmetic it runs on; the counts are
those of ``PERF.md``'s kernel table (``chip_smoke.py``'s ``msda_bound``,
``msda_bwd_bound`` and ``k2_bound``), copied here.

The model's FLOPs are counted from the configuration's shapes: the plain
reference (``benchmark/reference``) runs on the ``meta`` device under
``torch.utils.flop_counter.FlopCounterMode``, which counts every matrix
product and convolution by its shapes (two operations a multiply-add),
whatever implements them in the program.  Multi-scale deformable
attention's bilinear sampling (``grid_sample`` in the reference, float32
on CUDA cores in K1) is not counted: the model's FLOPs are held against
the tensor cores' peak.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}

def least_ms(nbytes: float, flops: float, dtype: str) -> float:
    """The least time in ms of a call moving ``nbytes`` and computing
    ``flops`` at ``dtype``'s peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]) * 1e3


def pyramid_shapes(h: int, w: int, levels: int = 4) -> Tuple[Tuple[int, int], ...]:
    """Feature-map sizes of an (h, w) canvas: level l is ceil(x / 2**(3+l))."""
    return tuple((math.ceil(h / 2 ** (3 + i)), math.ceil(w / 2 ** (3 + i)))
                 for i in range(levels))


# ----------------------------------------------------------------------- K1
def k1_fwd_counts(b: int, s: int, lq: int, m: int, d: int, levels: int,
                  points: int, value_dtype: str) -> Tuple[float, float]:
    """(bytes, float32 operations) of one K1 forward: value (B, S, M, D)
    in ``value_dtype``, sampling locations and attention weights in
    float32 read once, the (B, Lq, M*D) output written once; per sample
    and channel 4 corner multiply-adds and the weight (10 operations)."""
    es = DTYPE_BYTES[value_dtype]
    samples = b * lq * m * levels * points
    nbytes = b * s * m * d * es + samples * 2 * 4 + samples * 4 \
        + b * lq * m * d * es
    return nbytes, samples * d * 10.0


def k1_fwd_ms(*args) -> float:
    nbytes, flops = k1_fwd_counts(*args)
    return least_ms(nbytes, flops, "float32")


def k1_bwd_counts(b: int, s: int, lq: int, m: int, d: int, levels: int,
                  points: int, value_dtype: str) -> Tuple[float, float]:
    """(bytes, float32 operations) of one K1 backward: value, locations,
    weights and the output's gradient read once, the three gradients
    written once (the value's in its dtype); per sample and channel the
    sample again (8), the weight's gradient (2), the location's (2 x 7)
    and the four corners' scaled adds (8)."""
    es = DTYPE_BYTES[value_dtype]
    samples = b * lq * m * levels * points
    nbytes = 2 * b * s * m * d * es + 2 * (samples * 2 + samples) * 4 \
        + b * lq * m * d * es
    return nbytes, samples * d * 32.0


def k1_bwd_ms(*args) -> float:
    nbytes, flops = k1_bwd_counts(*args)
    return least_ms(nbytes, flops, "float32")


# ----------------------------------------------------------------------- K2
def k2_fwd_counts(b: int, h: int, w: int, c: int, l: int, heads: int,
                  has_bias: bool, dtype: str) -> Tuple[float, float]:
    """(bytes, operations at ``dtype``) of one K2 forward on a padded
    (B, H, W, C) map in groups of L tokens: x and pos read and the output
    written once, the mask, the float32 projections and the (heads, L, L)
    float32 bias table read once; the four projections (8 C^2 a token)
    and the two attention products (4 L C a token)."""
    tokens = b * h * w
    es = DTYPE_BYTES[dtype]
    nbytes = 3 * tokens * c * es + tokens + (4 * c * c + 4 * c) * 4 \
        + (heads * l * l * 4 if has_bias else 0)
    return nbytes, 8.0 * c * c * tokens + 4.0 * l * c * tokens


def k2_fwd_ms(*args) -> float:
    nbytes, flops = k2_fwd_counts(*args)
    return least_ms(nbytes, flops, args[-1])


# ------------------------------------------------------------- model FLOPs
def _counted(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _meta_model(config: dict):
    from .reference import build
    return build(config).to("meta")


@functools.lru_cache(maxsize=None)
def _frame_flops(config_items: tuple, canvas: Tuple[int, int]
                 ) -> Dict[str, float]:
    config = dict(config_items)
    model = _meta_model(config)
    h, w = canvas
    slots = config["TRACK_SLOTS"]
    c = config["HIDDEN_DIM"]
    images = torch.zeros((1, h, w, 3), device="meta")
    mask = torch.zeros((1, h, w), dtype=torch.bool, device="meta")
    q = torch.zeros((1, slots, c), device="meta")
    ref = torch.zeros((1, slots, 4), device="meta")
    tmask = torch.ones((1, slots), dtype=torch.bool, device="meta")
    with torch.no_grad():
        total = _counted(lambda: model(images, mask, q, ref, tmask))
        k = model.num_classes
        emb = torch.zeros((1, slots, c), device="meta")
        updater = _counted(lambda: model.query_updater(
            q, ref, torch.zeros((1, slots, k), device="meta"),
            torch.zeros((1, slots, 4), device="meta"), emb, emb, emb, tmask))
    return {"forward": total, "updater": updater}


def frame_flops(config: dict, canvas: Tuple[int, int]) -> Dict[str, float]:
    """Operations of one frame of the configuration's model on an (H, W)
    canvas with every track slot in use, counting matrix products and
    convolutions: ``forward`` (the model's forward), ``updater`` (the
    query updater's) and ``total`` (forward + updater)."""
    items = tuple(sorted((k, v) for k, v in config.items()
                         if isinstance(v, (int, float, str, bool, type(None)))))
    out = dict(_frame_flops(items, tuple(canvas)))
    out["total"] = out["forward"] + out["updater"]
    return out


def stream_frame_flops(config: dict, canvas) -> float:
    """Model FLOPs of one streamed frame."""
    return frame_flops(config, canvas)["total"]
