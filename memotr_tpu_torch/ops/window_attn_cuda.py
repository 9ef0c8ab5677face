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

``ops/window_attn.py: window_attention`` is the one route to them:
without a gradient it calls the ``window_attn_fwd`` op (``ops/library.py``),
whose CUDA implementation is ``window_attention_fwd``, and saves nothing;
with one, ``WindowAttnFunction``, whose backward launches the backward
kernel between the projection products, which stay ``torch.matmul``.

``launches`` / ``bwd_launches`` count calls that launched the forward /
backward kernel (one per call: the CUDA kernels of one call are one
launch), and nothing else.  ``routes`` counts the forward calls by route:
``"wgmma"`` (bfloat16, C = 64 ... 256, head dim 16, 32 or 64, groups of at
most 512 keys: the Hopper kernel, a block of two warpgroups each owning a
64-row tile across all heads, the projections and the output projection on
``wgmma`` with the weights streamed by TMA, the attention core on
``mma.sync``; groups of L <= 64 in one launch after the weights' bf16
rounding, larger groups through a K/V scratch in a second; no head-output
map unless a gradient asks for it) or ``"cuda_cores"`` (float32, and the
bf16 shapes the wgmma route does not take: three CUDA kernels through a
Q/K/V scratch).  ``bwd_routes``
counts the backward calls by the route of their attention core:
``"tensor_cores"`` (bfloat16, head dim 16, 32 or 64, a block per head over
whole groups: the windows and the smaller grid groups),
``"tensor_cores_tiled"`` (the same dtypes, larger groups: a rows kernel and
a keys kernel over tiles of a group) or ``"cuda_cores"`` (float32 and the
other shapes).
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
routes = {"wgmma": 0, "cuda_cores": 0}
bwd_routes = {"tensor_cores": 0, "tensor_cores_tiled": 0, "cuda_cores": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, pos, mask, w_in, b_in, w_out, b_out, bias, scratch, o, out; dtype, B,
# Hp, Wp, C, heads, wh, ww; stream.  window_attn_plan: dtype, B, Hp, Wp, C,
# heads, wh, ww, bias; out (scratch elements)
_ARGTYPES = {"window_attn_fwd": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
             + [ctypes.c_void_p],
             "window_attn_plan": [ctypes.c_int] * 9
             + [ctypes.POINTER(ctypes.c_longlong)]}
# x, pos, gy, mask, w_in, b_in, w_out, bias, proj, wmask, fws, dqkv,
# g_bias; dtype, B, Hp, Wp, C, heads, wh, ww; stream.
# window_attn_bwd_plan: dtype, B, Hp, Wp, C, heads, wh, ww, bias; out (2
# long long)
_BWD_ARGTYPES = {"window_attn_bwd": [ctypes.c_void_p] * 13
                 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
                 "window_attn_bwd_plan": [ctypes.c_int] * 9
                 + [ctypes.POINTER(ctypes.c_longlong)]}
_BWD_ROUTES = {1: "cuda_cores", 2: "tensor_cores", 3: "tensor_cores_tiled"}


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
                         n_heads: int, window_h: int, window_w: int,
                         head_outputs: bool = True
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel on checked inputs -> (out (B, H, W, C),
    o: the head outputs (B*H*W, C) in window order, which the backward's
    output-projection gradient reads; None unless ``head_outputs``, and
    then the wgmma route allocates and writes no head-output map)."""
    global launches
    _check(x, pos, mask, in_proj_weight, in_proj_bias, out_weight, out_bias,
           bias, n_heads, window_h, window_w)
    b, h, w, c = x.shape
    lib = _build.load(NAME, _ARGTYPES)
    n_scratch = ctypes.c_longlong()
    tc = lib.window_attn_plan(_DTYPES[x.dtype], b, h, w, c, n_heads,
                              window_h, window_w, int(bias is not None),
                              ctypes.byref(n_scratch)) == 1
    if tc:                                    # 16-byte loads of these rows
        for name, t in (("x", x), ("pos", pos),
                        ("in_proj_weight", in_proj_weight),
                        ("out_weight", out_weight)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(x)
    o = torch.empty((b * h * w, c), dtype=x.dtype, device=x.device) \
        if head_outputs or not tc else None
    scratch = torch.empty((n_scratch.value,), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.window_attn_fwd(
        x.data_ptr(), pos.data_ptr(), mask.data_ptr(),
        in_proj_weight.data_ptr(), in_proj_bias.data_ptr(),
        out_weight.data_ptr(), out_bias.data_ptr(),
        bias.data_ptr() if bias is not None else None, scratch.data_ptr(),
        o.data_ptr() if o is not None else None, out.data_ptr(),
        _DTYPES[x.dtype], b, h, w, c, n_heads, window_h, window_w, stream)
    if rc != 0:
        raise RuntimeError(f"window_attn_fwd launch failed: CUDA error {rc} "
                           f"(window {window_h}x{window_w}, C={c}, "
                           f"{n_heads} heads)")
    launches += 1
    routes["wgmma" if tc else "cuda_cores"] += 1
    return out, (o if head_outputs else None)


def _merge(o: torch.Tensor, b: int, h: int, w: int, wh: int,
           ww: int) -> torch.Tensor:
    """Head outputs in window order (B*H*W, C) -> pixel order (B*H*W, C)."""
    c = o.shape[-1]
    return o.view(b, h // wh, w // ww, wh, ww, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b * h * w, c)


def bwd_scratch(n_partials: int, n_stats: int, n_tokens: int, c: int,
                n_heads: int, l: int) -> dict:
    """Shapes of the backward kernel's scratch from its plan
    (``window_attn_bwd_plan``): ``proj``, Q, K, V and dO of every token in
    window order (4, heads, tokens, head dim), in the activation dtype;
    ``wmask``, the key flags in window order (tokens,) bytes; ``fws``,
    float32, the ``n_partials`` partial bias tables (heads, L, L) and then
    ``n_stats`` row statistics."""
    return {"proj": (4, n_heads, n_tokens, c // n_heads),
            "wmask": (n_tokens,),
            "fws": (n_partials * n_heads * l * l + n_stats,)}


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, its data 16-byte aligned (the kernels' loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


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

    The kernel (``csrc/window_attn_bwd.cu``) computes Q, K, V and dO from
    x + pos, x and the cotangent itself, then the attention core and the
    bias gradient.  The products that reduce over every token stay
    ``torch.matmul`` in the activation dtype (float32 accumulation), as
    autograd of the plain version does them: the output projection's
    gradients from the head outputs ``o`` of the forward, the input
    projection's from [dQ dK dV], the bias gradients (a row of ones times
    the cotangent or [dQ dK dV]), and g_qin = [dQ dK] [Wq; Wk], g_vin =
    dV Wv, g_pos = g_qin and g_x = g_qin + g_vin."""
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
    plan = (ctypes.c_longlong * 2)()
    route = lib.window_attn_bwd_plan(_DTYPES[dt], b, h, w, c, n_heads,
                                     window_h, window_w,
                                     int(bias is not None), plan)
    if route not in _BWD_ROUTES:
        raise ValueError(f"window-attention backward kernel does not take "
                         f"L={l} at head dim {c // n_heads} (its block "
                         "would exceed the card's shared memory)")
    shapes = bwd_scratch(plan[0], plan[1], n, c, n_heads, l)
    gy = _aligned(grad_out.to(dt))
    x, pos = _aligned(x), _aligned(pos)
    w_in, w_out = _aligned(in_proj_weight.to(dt)), _aligned(out_weight.to(dt))
    b_in = in_proj_bias.to(dt).contiguous()
    proj = torch.empty(shapes["proj"], dtype=dt, device=x.device)
    wmask = torch.empty(shapes["wmask"], dtype=torch.uint8, device=x.device)
    fws = torch.empty(shapes["fws"], dtype=torch.float32, device=x.device)
    dqkv = torch.empty((n, 3 * c), dtype=dt, device=x.device)
    g_bias = torch.empty((n_heads, l, l), dtype=torch.float32,
                         device=x.device) if bias is not None else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.window_attn_bwd(
        x.data_ptr(), pos.data_ptr(), gy.data_ptr(), mask.data_ptr(),
        w_in.data_ptr(), b_in.data_ptr(), w_out.data_ptr(),
        bias.data_ptr() if bias is not None else None, proj.data_ptr(),
        wmask.data_ptr(), fws.data_ptr(), dqkv.data_ptr(),
        g_bias.data_ptr() if g_bias is not None else None, _DTYPES[dt], b, h,
        w, c, n_heads, window_h, window_w, stream)
    if rc != 0:
        raise RuntimeError(f"window_attn_bwd launch failed: CUDA error {rc} "
                           f"(window {window_h}x{window_w}, C={c}, "
                           f"{n_heads} heads)")
    bwd_launches += 1
    bwd_routes[_BWD_ROUTES[route]] += 1
    gy = gy.view(n, c)
    q_in = (x + pos).view(n, c)
    # the bias gradients as products with a row of ones: sums over every
    # token in float32 on the tensor cores, rounded to the activation dtype
    # as autograd of the plain version rounds them
    ones = torch.ones((1, n), dtype=dt, device=x.device)
    g_out_w = torch.matmul(gy.t(), _merge(o, b, h, w, window_h,
                                          window_w)).float()
    g_out_b = torch.matmul(ones, gy).view(c).float()
    g_in_w = torch.cat([torch.matmul(dqkv[:, :2 * c].t(), q_in),
                        torch.matmul(dqkv[:, 2 * c:].t(), x.view(n, c))]
                       ).float()
    g_in_b = torch.matmul(ones, dqkv).view(3 * c).float()
    g_qin = torch.matmul(dqkv[:, :2 * c], w_in[:2 * c])
    g_x = torch.addmm(g_qin, dqkv[:, 2 * c:], w_in[2 * c:])
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

