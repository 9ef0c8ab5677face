"""CUDA fused window-attention forward kernel (K2): ctypes binding, wrapper.

Replaces the TPU kernel ``window_attention_pallas``
(``memotr_tpu/ops/window_attn.py:245``; its ``pallas_call`` is at :214).
The kernel source is ``memotr_tpu_torch/csrc/window_attn_fwd.cu``; its
header says what bounds it on an H100 and how its design answers that.  It
is compiled with ``nvcc`` at first use and loaded with ``ctypes``
(``ops/_build.py``).

``launches`` counts calls that launched the kernel (one per call: the
CUDA kernels of one call are one K2 launch), and nothing else.  ``routes``
counts the same calls by route: ``"fused"`` (bfloat16 on the tensor cores:
QKV projection + attention in one CUDA kernel, the output projection in a
second; no Q/K/V in device memory) or ``"cuda_cores"`` (float32, and bf16
shapes the fused route does not take: three CUDA kernels through a Q/K/V
scratch).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NAME = "window_attn_fwd"

launches = 0
routes = {"fused": 0, "cuda_cores": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, pos, mask, w_in, b_in, w_out, b_out, bias, qkv, o, out; dtype, B, Hp,
# Wp, C, heads, wh, ww; stream.  window_attn_fused: dtype, C, heads, L, bias
_ARGTYPES = {"window_attn_fwd": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
             + [ctypes.c_void_p],
             "window_attn_fused": [ctypes.c_int] * 5}


def window_attention_cuda(x: torch.Tensor, pos: torch.Tensor,
                          mask: torch.Tensor, in_proj_weight: torch.Tensor,
                          in_proj_bias: torch.Tensor, out_weight: torch.Tensor,
                          out_bias: torch.Tensor, bias: Optional[torch.Tensor],
                          n_heads: int, window_h: int,
                          window_w: int) -> torch.Tensor:
    """Launch K2; same contract as ``window_attention_torch``.

    Raises on what the kernel does not take (device, dtype, shape,
    contiguity), when a gradient is asked for (the backward kernel comes
    with the windowed-training slice, ROADMAP.md queue 1, slice 3) and when
    a launch fails."""
    global launches
    params = (in_proj_weight, in_proj_bias, out_weight, out_bias)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, pos, bias) + params):
        raise NotImplementedError(
            "window-attention CUDA kernel is forward-only; its backward "
            "kernel comes with the windowed-training slice (ROADMAP.md "
            "queue 1, slice 3; run inference under "
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
    if b * h * w >= 2 ** 31:                  # the kernel's 32-bit addressing
        raise ValueError(f"{b}x{h}x{w} tokens: at most 2^31 - 1")
    want = {"pos": (b, h, w, c), "mask": (b, h, w),
            "in_proj_weight": (3 * c, c), "in_proj_bias": (3 * c,),
            "out_weight": (c, c), "out_bias": (c,), "bias": (n_heads, l, l)}
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
    lib = _build.load(NAME, _ARGTYPES)
    fused = bool(lib.window_attn_fused(_DTYPES[x.dtype], c, n_heads, l,
                                       int(bias is not None)))
    if fused:                                 # 16-byte loads of these rows
        for name, t in (("x", x), ("pos", pos),
                        ("in_proj_weight", in_proj_weight),
                        ("out_weight", out_weight)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(x)
    o = torch.empty_like(x)                   # head outputs, window order
    qkv = None if fused else torch.empty((3,) + tuple(x.shape),
                                         dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.window_attn_fwd(
        x.data_ptr(), pos.data_ptr(), mask.data_ptr(),
        in_proj_weight.data_ptr(), in_proj_bias.data_ptr(),
        out_weight.data_ptr(), out_bias.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        qkv.data_ptr() if qkv is not None else None,
        o.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], b, h, w, c, n_heads,
        window_h, window_w, stream)
    if rc != 0:
        raise RuntimeError(f"window_attn_fwd launch failed: CUDA error {rc} "
                           f"(window {window_h}x{window_w}, C={c}, "
                           f"{n_heads} heads)")
    launches += 1
    routes["fused" if fused else "cuda_cores"] += 1
    return out
