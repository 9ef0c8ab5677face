"""CUDA MSDA forward kernel: ctypes binding and wrapper.

Replaces the TPU kernel ``ms_deform_attn_pallas``
(``memotr_tpu/ops/msda_pallas.py:220``; its ``pallas_call`` is at :187).
The kernel source is ``memotr_tpu_torch/csrc/msda_fwd.cu``; its header says
what bounds it on an H100 and how its design answers that.  It is compiled
with ``nvcc`` at first use and loaded with ``ctypes`` (``ops/_build.py``).

``launches`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from . import _build

NAME = "msda_fwd"

launches = 0
_shape_tables: Dict[Tuple, torch.Tensor] = {}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# value, shape table, loc, aw, out; dtype, B, S, Lq, M, D, L, P; stream
_ARGTYPES = {"msda_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_void_p]}


def _shape_table(spatial_shapes: Sequence[Tuple[int, int]],
                 device: torch.device) -> torch.Tensor:
    """(L, 3) int32 [H, W, start row] on the device, made once per shapes."""
    key = (tuple(map(tuple, spatial_shapes)), device)
    tab = _shape_tables.get(key)
    if tab is None:
        rows, start = [], 0
        for h, w in spatial_shapes:
            rows.append((h, w, start))
            start += h * w
        tab = torch.tensor(rows, dtype=torch.int32, device=device)
        _shape_tables[key] = tab
    return tab


def ms_deform_attn_cuda(value: torch.Tensor,
                        spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel; same contract as ``ms_deform_attn_torch``.

    Raises on what the kernel does not take (device, dtype, shape,
    contiguity) and when a gradient is asked for: the backward kernel comes
    with the training slice."""
    global launches
    loc, aw = sampling_locations, attention_weights
    if torch.is_grad_enabled() and (value.requires_grad or loc.requires_grad
                                    or aw.requires_grad):
        raise NotImplementedError(
            "MSDA CUDA kernel is forward-only; its backward kernel comes with "
            "the training slice (run inference under torch.inference_mode())")
    for name, t in (("value", value), ("sampling_locations", loc),
                    ("attention_weights", aw)):
        if not t.is_cuda or t.device != value.device:
            raise ValueError(f"{name} must be on {value.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if value.dtype not in _DTYPES:
        raise TypeError(f"value dtype {value.dtype} not supported "
                        "(float32 or bfloat16)")
    if loc.dtype != torch.float32 or aw.dtype != torch.float32:
        raise TypeError("sampling_locations and attention_weights must be "
                        "float32")
    if value.dim() != 4 or loc.dim() != 6 or aw.dim() != 5:
        raise ValueError("expected value (B,S,M,D), loc (B,Lq,M,L,P,2), "
                         "aw (B,Lq,M,L,P)")
    b, s, m, d = value.shape
    lq, nl, p = loc.shape[1], loc.shape[3], loc.shape[4]
    if tuple(loc.shape) != (b, lq, m, nl, p, 2) or \
            tuple(aw.shape) != (b, lq, m, nl, p):
        raise ValueError(f"shape mismatch: value {tuple(value.shape)}, loc "
                         f"{tuple(loc.shape)}, aw {tuple(aw.shape)}")
    if not 1 <= nl <= 4 or nl != len(spatial_shapes):
        raise ValueError(f"{nl} levels in loc, {len(spatial_shapes)} shapes; "
                         "the kernel takes 1-4 levels")
    if s != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value has {s} rows, shapes give "
                         f"{sum(h * w for h, w in spatial_shapes)}")
    if d not in (4, 8, 16) and (d < 32 or d % 32):
        raise ValueError(f"head dim {d} not supported (4, 8, 16 or a "
                         "multiple of 32)")
    for name, t in (("value", value), ("sampling_locations", loc),
                    ("attention_weights", aw)):
        if t.data_ptr() % 16:                 # 16-byte loads of their rows
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = _build.load(NAME, _ARGTYPES)
    table = _shape_table(spatial_shapes, value.device)
    out = torch.empty((b, lq, m * d), dtype=value.dtype, device=value.device)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    rc = lib.msda_fwd(value.data_ptr(), table.data_ptr(), loc.data_ptr(),
                      aw.data_ptr(), out.data_ptr(), _DTYPES[value.dtype],
                      b, s, lq, m, d, nl, p, stream)
    if rc != 0:
        raise RuntimeError(f"msda_fwd launch failed: CUDA error {rc}")
    launches += 1
    return out
