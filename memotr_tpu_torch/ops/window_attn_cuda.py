"""CUDA fused window-attention forward kernel (K2): ctypes binding, wrapper.

Replaces the TPU kernel ``window_attention_pallas``
(``memotr_tpu/ops/window_attn.py:245``; its ``pallas_call`` is at :214).
The kernel source is ``memotr_tpu_torch/csrc/window_attn_fwd.cu``; its
header says what bounds it on an H100 and how its design answers that.  It
is compiled with ``nvcc`` at first use and loaded with ``ctypes``
(``ops/_build.py``).

``launches`` counts calls that launched the kernel (one per call: the
three CUDA kernels of one call are one K2 launch), and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NAME = "window_attn_fwd"

launches = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, pos, mask, w_in, b_in, w_out, b_out, bias, qkv, o, out; dtype, B, Hp,
# Wp, C, heads, wh, ww; stream
_ARGTYPES = {"window_attn_fwd": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
             + [ctypes.c_void_p]}


def window_attention_cuda(x: torch.Tensor, pos: torch.Tensor,
                          mask: torch.Tensor, in_proj_weight: torch.Tensor,
                          in_proj_bias: torch.Tensor, out_weight: torch.Tensor,
                          out_bias: torch.Tensor, bias: Optional[torch.Tensor],
                          n_heads: int, window_h: int,
                          window_w: int) -> torch.Tensor:
    """Launch K2; same contract as ``window_attention_torch``.

    Raises on what the kernel does not take (device, dtype, shape,
    contiguity), when a gradient is asked for (the backward kernel comes
    with the training slice) and when a launch fails."""
    global launches
    params = (in_proj_weight, in_proj_bias, out_weight, out_bias)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, pos, bias) + params):
        raise NotImplementedError(
            "window-attention CUDA kernel is forward-only; its backward "
            "kernel comes with the training slice (run inference under "
            "torch.inference_mode())")
    named = [("x", x), ("pos", pos), ("mask", mask),
             ("in_proj_weight", in_proj_weight),
             ("in_proj_bias", in_proj_bias), ("out_weight", out_weight),
             ("out_bias", out_bias)] + ([("bias", bias)] if bias is not None
                                        else [])
    for name, t in named:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPES or pos.dtype != x.dtype:
        raise TypeError(f"x and pos must both be float32 or bfloat16, got "
                        f"{x.dtype} and {pos.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    for name, t in named[3:]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    l = window_h * window_w
    if h % window_h or w % window_w:
        raise ValueError(f"map {h}x{w} is not padded to {window_h}x{window_w} "
                         "windows")
    if c % n_heads:
        raise ValueError(f"C={c} is not a multiple of {n_heads} heads")
    want = {"pos": (b, h, w, c), "mask": (b, h, w),
            "in_proj_weight": (3 * c, c), "in_proj_bias": (3 * c,),
            "out_weight": (c, c), "out_bias": (c,), "bias": (n_heads, l, l)}
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
    lib = _build.load(NAME, _ARGTYPES)
    out = torch.empty_like(x)
    qkv = torch.empty((3,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    o = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.window_attn_fwd(
        x.data_ptr(), pos.data_ptr(), mask.data_ptr(),
        in_proj_weight.data_ptr(), in_proj_bias.data_ptr(),
        out_weight.data_ptr(), out_bias.data_ptr(),
        bias.data_ptr() if bias is not None else None, qkv.data_ptr(),
        o.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], b, h, w, c, n_heads,
        window_h, window_w, stream)
    if rc != 0:
        raise RuntimeError(f"window_attn_fwd launch failed: CUDA error {rc} "
                           f"(window {window_h}x{window_w}, C={c}, "
                           f"{n_heads} heads)")
    launches += 1
    return out
