"""CUDA fused window-attention kernels (K2), forward and backward: ctypes
bindings, wrappers and the autograd Function that joins them.

The forward replaces the TPU kernel ``window_attention_pallas``
(``memotr_tpu/ops/window_attn.py:245``; its ``pallas_call`` is at :214),
the backward that kernel's custom VJP (``_bwd``, window_attn.py:263: the
VJP of ``window_attention_xla``, :61).  Their sources are
``memotr_tpu_torch/csrc/window_attn_fwd.cu`` and ``csrc/window_attn_bwd.cu``;
each header says what bounds it on an H100 and how its design answers
that.  They are compiled with ``nvcc`` at first use and loaded with
``ctypes`` (``ops/_build.py``).

``window_attention_cuda`` launches the forward alone when no gradient is
asked for (``torch.inference_mode()``, ``torch.no_grad()`` or inputs that
do not require grad) and saves nothing; otherwise it goes through
``WindowAttnFunction``, whose backward launches the backward kernel
between the projection products, which stay ``torch.matmul``.

``launches`` / ``bwd_launches`` count calls that launched the forward /
backward kernel (one per call: the CUDA kernels of one call are one
launch), and nothing else.  ``routes`` counts the forward calls by route:
``"fused"`` (bfloat16 on the tensor cores: QKV projection + attention in
one CUDA kernel, the output projection in a second; no Q/K/V in device
memory) or ``"cuda_cores"`` (float32, and bf16 shapes the fused route does
not take: three CUDA kernels through a Q/K/V scratch).  ``bwd_routes``
counts the backward calls by route: ``"tensor_cores"`` (bfloat16, head dim
16, 32 or 64) or ``"cuda_cores"`` (float32 and the other shapes).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _build

NAME = "window_attn_fwd"
BWD_NAME = "window_attn_bwd"

launches = 0
bwd_launches = 0
routes = {"fused": 0, "cuda_cores": 0}
bwd_routes = {"tensor_cores": 0, "cuda_cores": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, pos, mask, w_in, b_in, w_out, b_out, bias, qkv, o, out; dtype, B, Hp,
# Wp, C, heads, wh, ww; stream.  window_attn_fused: dtype, C, heads, L, bias
_ARGTYPES = {"window_attn_fwd": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
             + [ctypes.c_void_p],
             "window_attn_fused": [ctypes.c_int] * 5}
# qk, v, d_o, mask, bias, dqkv, dbias; dtype, B, Hp, Wp, C, heads, wh, ww;
# stream.  window_attn_bwd_route: dtype, C, heads, L, bias
_BWD_ARGTYPES = {"window_attn_bwd": [ctypes.c_void_p] * 7
                 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
                 "window_attn_bwd_route": [ctypes.c_int] * 5}
_BWD_ROUTES = {1: "cuda_cores", 2: "tensor_cores"}


def _check(x: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor,
           in_proj_weight: torch.Tensor, in_proj_bias: torch.Tensor,
           out_weight: torch.Tensor, out_bias: torch.Tensor,
           bias: Optional[torch.Tensor], n_heads: int, window_h: int,
           window_w: int) -> None:
    """Raise on what the kernels do not take (device, dtype, shape,
    contiguity)."""
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
    if b * h * w >= 2 ** 31:                  # the kernels' 32-bit addressing
        raise ValueError(f"{b}x{h}x{w} tokens: at most 2^31 - 1")
    want = {"pos": (b, h, w, c), "mask": (b, h, w),
            "in_proj_weight": (3 * c, c), "in_proj_bias": (3 * c,),
            "out_weight": (c, c), "out_bias": (c,), "bias": (n_heads, l, l)}
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")


def window_attention_fwd(x: torch.Tensor, pos: torch.Tensor,
                         mask: torch.Tensor, in_proj_weight: torch.Tensor,
                         in_proj_bias: torch.Tensor, out_weight: torch.Tensor,
                         out_bias: torch.Tensor, bias: Optional[torch.Tensor],
                         n_heads: int, window_h: int, window_w: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on checked inputs -> (out (B, H, W, C),
    o: the head outputs (B*H*W, C) in window order, which the backward's
    output-projection gradient reads)."""
    global launches
    _check(x, pos, mask, in_proj_weight, in_proj_bias, out_weight, out_bias,
           bias, n_heads, window_h, window_w)
    b, h, w, c = x.shape
    lib = _build.load(NAME, _ARGTYPES)
    fused = bool(lib.window_attn_fused(_DTYPES[x.dtype], c, n_heads,
                                       window_h * window_w,
                                       int(bias is not None)))
    if fused:                                 # 16-byte loads of these rows
        for name, t in (("x", x), ("pos", pos),
                        ("in_proj_weight", in_proj_weight),
                        ("out_weight", out_weight)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(x)
    o = torch.empty((b * h * w, c), dtype=x.dtype, device=x.device)
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
    return out, o


def _merge(o: torch.Tensor, b: int, h: int, w: int, wh: int,
           ww: int) -> torch.Tensor:
    """Head outputs in window order (B*H*W, C) -> pixel order (B*H*W, C)."""
    c = o.shape[-1]
    return o.view(b, h // wh, w // ww, wh, ww, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b * h * w, c)


def _attention_core_bwd(lib, qk, v, d_o, mask, bias, shape, n_heads,
                        window_h, window_w):
    """Launch the backward kernel -> (dqkv (B*H*W, 3C): [dQ dK dV] of the
    projection outputs in pixel order, g_bias (heads, L, L) float32 summed
    by float32 atomics into a zeroed table, or None)."""
    b, h, w, c = shape
    l = window_h * window_w
    dqkv = torch.empty((b * h * w, 3 * c), dtype=qk.dtype, device=qk.device)
    g_bias = torch.zeros((n_heads, l, l), dtype=torch.float32,
                         device=qk.device) if bias is not None else None
    stream = torch.cuda.current_stream(qk.device).cuda_stream
    rc = lib.window_attn_bwd(
        qk.data_ptr(), v.data_ptr(), d_o.data_ptr(), mask.data_ptr(),
        bias.data_ptr() if bias is not None else None, dqkv.data_ptr(),
        g_bias.data_ptr() if g_bias is not None else None,
        _DTYPES[qk.dtype], b, h, w, c, n_heads, window_h, window_w, stream)
    if rc != 0:
        raise RuntimeError(f"window_attn_bwd launch failed: CUDA error {rc} "
                           f"(window {window_h}x{window_w}, C={c}, "
                           f"{n_heads} heads)")
    return dqkv, g_bias


def window_attention_bwd(grad_out: torch.Tensor, x: torch.Tensor,
                         pos: torch.Tensor, mask: torch.Tensor,
                         in_proj_weight: torch.Tensor,
                         in_proj_bias: torch.Tensor, out_weight: torch.Tensor,
                         out_bias: torch.Tensor, bias: Optional[torch.Tensor],
                         o: torch.Tensor, n_heads: int, window_h: int,
                         window_w: int) -> Tuple[Optional[torch.Tensor], ...]:
    """The VJP of ``window_attention`` -> (g_x, g_pos in x's dtype;
    g_in_proj_weight, g_in_proj_bias, g_out_weight, g_out_bias, g_bias
    (None without bias) in float32).

    The projection products are ``torch.matmul`` in the activation dtype
    (float32 accumulation), as autograd of the plain version does them:
    dO = gy Wo, the output projection's gradients from the head outputs
    ``o`` of the forward, Q, K and V recomputed from x + pos and x into a
    scratch, then the kernel (``csrc/window_attn_bwd.cu``: the attention
    core and the bias gradient), then the input projection's gradients and
    g_qin = [dQ dK] [Wq; Wk], g_vin = dV Wv, g_pos = g_qin and g_x = g_qin
    + g_vin."""
    global bwd_launches
    _check(x, pos, mask, in_proj_weight, in_proj_bias, out_weight, out_bias,
           bias, n_heads, window_h, window_w)
    b, h, w, c = x.shape
    n, l, dt = b * h * w, window_h * window_w, x.dtype
    if tuple(grad_out.shape) != tuple(x.shape) or \
            grad_out.device != x.device:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} on "
                         f"{grad_out.device}, expected {tuple(x.shape)} on "
                         f"{x.device}")
    if tuple(o.shape) != (n, c) or o.dtype != dt or not o.is_contiguous():
        raise ValueError(f"head outputs must be contiguous ({n}, {c}) {dt}")
    lib = _build.load(BWD_NAME, _BWD_ARGTYPES)
    route = lib.window_attn_bwd_route(_DTYPES[dt], c, n_heads, l,
                                      int(bias is not None))
    if route not in _BWD_ROUTES:
        raise ValueError(f"window-attention backward kernel does not take "
                         f"L={l} at head dim {c // n_heads} (its block "
                         "would exceed the card's shared memory)")
    gy = grad_out.to(dt).contiguous().view(n, c)
    w_in, w_out = in_proj_weight.to(dt), out_weight.to(dt)
    b_in = in_proj_bias.to(dt)
    q_in = (x + pos).view(n, c)
    x2 = x.view(n, c)
    qk = torch.addmm(b_in[:2 * c], q_in, w_in[:2 * c].t())
    v = torch.addmm(b_in[2 * c:], x2, w_in[2 * c:].t())
    d_o = torch.matmul(gy, w_out)
    dqkv, g_bias = _attention_core_bwd(lib, qk, v, d_o, mask, bias, x.shape,
                                       n_heads, window_h, window_w)
    bwd_launches += 1
    bwd_routes[_BWD_ROUTES[route]] += 1
    g_out_w = torch.matmul(gy.t(), _merge(o, b, h, w, window_h,
                                          window_w)).float()
    g_out_b = gy.sum(0, dtype=torch.float32)
    g_in_w = torch.cat([torch.matmul(dqkv[:, :2 * c].t(), q_in),
                        torch.matmul(dqkv[:, 2 * c:].t(), x2)]).float()
    g_in_b = dqkv.sum(0, dtype=torch.float32)
    g_qin = torch.matmul(dqkv[:, :2 * c], w_in[:2 * c])
    g_x = g_qin + torch.matmul(dqkv[:, 2 * c:], w_in[2 * c:])
    return (g_x.view(b, h, w, c), g_qin.view(b, h, w, c), g_in_w, g_in_b,
            g_out_w, g_out_b, g_bias)


class WindowAttnFunction(torch.autograd.Function):
    """Forward kernel forward, backward kernel (and its projection
    products) backward."""

    @staticmethod
    def forward(ctx, x, pos, mask, in_proj_weight, in_proj_bias, out_weight,
                out_bias, bias, n_heads, window_h, window_w):
        out, o = window_attention_fwd(x, pos, mask, in_proj_weight,
                                      in_proj_bias, out_weight, out_bias,
                                      bias, n_heads, window_h, window_w)
        ctx.geo = (n_heads, window_h, window_w)
        ctx.save_for_backward(x, pos, mask, in_proj_weight, in_proj_bias,
                              out_weight, out_bias, bias, o)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, pos, mask, w_in, b_in, w_out, b_out, bias, o = ctx.saved_tensors
        gx, gpos, gwi, gbi, gwo, gbo, gb = window_attention_bwd(
            grad_out, x, pos, mask, w_in, b_in, w_out, b_out, bias, o,
            *ctx.geo)
        need = ctx.needs_input_grad
        grads = (gx, gpos, None, gwi, gbi, gwo, gbo, gb)
        return tuple(g if need[i] else None
                     for i, g in enumerate(grads)) + (None, None, None)


def window_attention_cuda(x: torch.Tensor, pos: torch.Tensor,
                          mask: torch.Tensor, in_proj_weight: torch.Tensor,
                          in_proj_bias: torch.Tensor, out_weight: torch.Tensor,
                          out_bias: torch.Tensor, bias: Optional[torch.Tensor],
                          n_heads: int, window_h: int,
                          window_w: int) -> torch.Tensor:
    """Same contract as ``window_attention_torch``, through the kernels.

    With a gradient asked for, the call goes through
    ``WindowAttnFunction`` (the backward kernel then runs in
    ``backward()``); otherwise it launches the forward kernel alone and
    saves nothing.  Raises on what the kernels do not take (device, dtype,
    shape, contiguity, alignment) and when a launch fails."""
    args = (x, pos, mask, in_proj_weight, in_proj_bias, out_weight, out_bias,
            bias, n_heads, window_h, window_w)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, pos, in_proj_weight, in_proj_bias, out_weight,
                      out_bias, bias)):
        return WindowAttnFunction.apply(*args)
    return window_attention_fwd(*args)[0]
