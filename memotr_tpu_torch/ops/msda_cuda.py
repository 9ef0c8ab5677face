"""CUDA MSDA kernels, forward and backward: ctypes bindings, wrappers and
the autograd Function that joins them.

The forward replaces the TPU kernel ``ms_deform_attn_pallas``
(``memotr_tpu/ops/msda_pallas.py:220``; its ``pallas_call`` is at :187),
the backward that kernel's custom VJP (``_bwd``, msda_pallas.py:237: the
VJP of ``ms_deform_attn_xla``).  Their sources are
``memotr_tpu_torch/csrc/msda_fwd.cu`` and ``csrc/msda_bwd.cu``; each
header says what the kernel computes and how.  They are compiled with
``nvcc`` at first use and loaded with ``ctypes`` (``ops/_build.py``).

``ms_deform_attn_cuda`` launches the forward alone when no gradient is
asked for (``torch.inference_mode()``, ``torch.no_grad()`` or inputs that
do not require grad), and otherwise goes through ``MSDeformAttnFunction``,
whose backward launches the backward kernel.

``launches`` / ``bwd_launches`` count launches of the forward / backward
kernel (and nothing else), so a run can show that its main path went
through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..utils.misc import host_to_device
from . import _build

NAME = "msda_fwd"
BWD_NAME = "msda_bwd"

launches = 0
bwd_launches = 0
_shape_tables: Dict[Tuple, torch.Tensor] = {}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# value, shape table, loc, aw, out; dtype, B, S, Lq, M, D, L, P; stream
_ARGTYPES = {"msda_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_void_p]}
# value, shape table, loc, aw, grad_out, grad_value (f32), grad_loc,
# grad_aw; dtype, B, S, Lq, M, D, L, P; stream
_BWD_ARGTYPES = {"msda_bwd": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
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
        tab = host_to_device(rows, device, torch.int32)
        _shape_tables[key] = tab
    return tab


def _check(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
           loc: torch.Tensor, aw: torch.Tensor) -> None:
    """Raise on what the kernels do not take (device, dtype, shape,
    contiguity, alignment)."""
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


def msda_forward(value: torch.Tensor,
                 spatial_shapes: Sequence[Tuple[int, int]],
                 loc: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on checked inputs -> (B, Lq, M*D)."""
    global launches
    _check(value, spatial_shapes, loc, aw)
    b, s, m, d = value.shape
    lq, nl, p = loc.shape[1], loc.shape[3], loc.shape[4]
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


def msda_backward(value: torch.Tensor,
                  spatial_shapes: Sequence[Tuple[int, int]],
                  loc: torch.Tensor, aw: torch.Tensor,
                  grad_out: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel -> (grad_value in the value dtype,
    grad_loc, grad_aw float32).  grad_value is summed by float32 atomics
    into a zeroed float32 buffer, then cast."""
    global bwd_launches
    _check(value, spatial_shapes, loc, aw)
    b, s, m, d = value.shape
    lq, nl, p = loc.shape[1], loc.shape[3], loc.shape[4]
    if tuple(grad_out.shape) != (b, lq, m * d) or \
            grad_out.device != value.device:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} on "
                         f"{grad_out.device}, expected {(b, lq, m * d)} on "
                         f"{value.device}")
    g = grad_out.to(value.dtype).contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    lib = _build.load(BWD_NAME, _BWD_ARGTYPES)
    table = _shape_table(spatial_shapes, value.device)
    grad_value = torch.zeros((b, s, m, d), dtype=torch.float32,
                             device=value.device)
    grad_loc = torch.empty_like(loc)
    grad_aw = torch.empty_like(aw)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    rc = lib.msda_bwd(value.data_ptr(), table.data_ptr(), loc.data_ptr(),
                      aw.data_ptr(), g.data_ptr(), grad_value.data_ptr(),
                      grad_loc.data_ptr(), grad_aw.data_ptr(),
                      _DTYPES[value.dtype], b, s, lq, m, d, nl, p, stream)
    if rc != 0:
        raise RuntimeError(f"msda_bwd launch failed: CUDA error {rc}")
    bwd_launches += 1
    return grad_value.to(value.dtype), grad_loc, grad_aw


class MSDeformAttnFunction(torch.autograd.Function):
    """Forward kernel forward, backward kernel backward."""

    @staticmethod
    def forward(ctx, value, loc, aw, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, loc, aw)
        return msda_forward(value, spatial_shapes, loc, aw)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        value, loc, aw = ctx.saved_tensors
        gv, gl, ga = msda_backward(value, ctx.spatial_shapes, loc, aw,
                                   grad_out)
        need = ctx.needs_input_grad
        return (gv if need[0] else None, gl if need[1] else None,
                ga if need[2] else None, None)


def ms_deform_attn_cuda(value: torch.Tensor,
                        spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """Same contract as ``ms_deform_attn_torch``, through the kernels.

    With a gradient asked for, the call goes through
    ``MSDeformAttnFunction`` (the backward kernel then runs in
    ``backward()``); otherwise it launches the forward kernel alone and
    saves nothing.  Raises on what the kernels do not take (device, dtype,
    shape, contiguity) and when a launch fails."""
    loc, aw = sampling_locations, attention_weights
    if torch.is_grad_enabled() and (value.requires_grad or loc.requires_grad
                                    or aw.requires_grad):
        return MSDeformAttnFunction.apply(value, loc, aw,
                                          tuple(map(tuple, spatial_shapes)))
    return msda_forward(value, spatial_shapes, loc, aw)
