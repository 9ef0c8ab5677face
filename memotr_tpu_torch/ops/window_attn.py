"""Fused window attention (kernel K2): plain PyTorch version + dispatch.

Counterpart of ``memotr_tpu/ops/window_attn.py``.  One block of windowed
multi-head self-attention on an already-padded map:

1. q = k = x + pos, v = x;
2. partition (B, H, W, C) into window_h x window_w windows of L tokens;
3. Q, K, V projections (``nn.MultiheadAttention`` layout: ``in_proj_weight``
   (3C, C), ``in_proj_bias`` (3C,));
4. logits / sqrt(head dim) + a per-head bias (n_heads, L, L);
5. key-padding mask (True = pad); a window whose keys are all padding is
   opened instead (its outputs are padding and never read);
6. float32 softmax, value mix, output projection (``out_weight`` (C, C),
   ``out_bias`` (C,));
7. merge the windows back into (B, H, W, C).

Grid (MaxViT) attention is the same block on a ``grid_transpose``-d map.

``window_attention`` dispatches by device: CPU tensors take the plain
version, CUDA tensors the hand-written kernel (``ops/window_attn_cuda.py``),
which raises on what it does not take; there is no fallback.  Without a
gradient the call is the torch op ``window_attn_fwd``
(``ops/library.py``), which a traced or exported graph carries as one
node.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def window_attention_torch(x: torch.Tensor, pos: torch.Tensor,
                           mask: torch.Tensor, in_proj_weight: torch.Tensor,
                           in_proj_bias: torch.Tensor,
                           out_weight: torch.Tensor, out_bias: torch.Tensor,
                           bias: Optional[torch.Tensor], n_heads: int,
                           window_h: int, window_w: int,
                           attn_dropout: Optional[Callable] = None
                           ) -> torch.Tensor:
    """Plain version; the numerics reference of the CUDA kernel, and the
    windowed encoder's composed route when dropout is active:
    ``attn_dropout`` maps the probabilities (after the softmax) to their
    dropped copy, as JAX's ``MultiheadAttention`` drops them.

    x, pos (B, H, W, C) with H % window_h == 0 and W % window_w == 0; mask
    (B, H, W) bool, True = pad; bias (n_heads, L, L) or None.  Returns the
    attention output map (B, H, W, C) in x's dtype, no residual.  The cast
    points are those of ``window_attention_xla``
    (``memotr_tpu/ops/window_attn.py:61``): x + pos, the projection
    outputs, the logits and the value mix in x's dtype, weights and biases
    cast to it, the softmax in float32."""
    b, h, w, c = x.shape
    wh, ww = window_h, window_w
    l = wh * ww
    dh = c // n_heads
    dt = x.dtype

    def part(t):
        t = t.reshape(b, h // wh, wh, w // ww, ww, t.shape[-1])
        return t.permute(0, 1, 3, 2, 4, 5).reshape(-1, l, t.shape[-1])

    q = part(x + pos.to(dt))
    xv = part(x)
    m = part(mask[..., None]).squeeze(-1)                   # (nW, L)
    m = m & ~m.all(dim=1, keepdim=True)                     # open dead windows
    wq, wk, wv = in_proj_weight.to(dt).chunk(3)
    bq, bk, bv = in_proj_bias.to(dt).chunk(3)

    def split(t):
        return t.reshape(-1, l, n_heads, dh).transpose(1, 2)

    qh = split(torch.matmul(q, wq.t()) + bq)
    kh = split(torch.matmul(q, wk.t()) + bk)
    vh = split(torch.matmul(xv, wv.t()) + bv)
    scale = torch.tensor(dh, dtype=torch.float32).sqrt().to(dt)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) / scale
    if bias is not None:
        logits = logits + bias[None].to(dt)
    # float32 softmax (float64 stays float64, for gradcheck)
    logits = logits.to(torch.promote_types(dt, torch.float32)).masked_fill(
        m[:, None, None, :], torch.finfo(torch.float32).min)
    attn = torch.softmax(logits, dim=-1).to(dt)
    if attn_dropout is not None:
        attn = attn_dropout(attn)
    out = torch.matmul(attn, vh).transpose(1, 2).reshape(-1, l, c)
    y = torch.matmul(out, out_weight.to(dt).t()) + out_bias.to(dt)
    y = y.reshape(b, h // wh, w // ww, wh, ww, c)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def window_attention(x: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor,
                     in_proj_weight: torch.Tensor, in_proj_bias: torch.Tensor,
                     out_weight: torch.Tensor, out_bias: torch.Tensor,
                     bias: Optional[torch.Tensor], n_heads: int,
                     window_h: int, window_w: int) -> torch.Tensor:
    """With a gradient asked for: CPU tensors -> the plain version, CUDA
    tensors -> ``WindowAttnFunction`` (the forward and backward kernels).
    Otherwise the ``window_attn_fwd`` op (``ops/library.py``): the forward
    kernel on CUDA tensors, the plain version on CPU tensors."""
    args = (x, pos, mask, in_proj_weight, in_proj_bias, out_weight, out_bias,
            bias, n_heads, window_h, window_w)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, pos, in_proj_weight, in_proj_bias, out_weight,
                      out_bias, bias)):
        if x.is_cuda:
            from .window_attn_cuda import WindowAttnFunction
            return WindowAttnFunction.apply(*args)
        return window_attention_torch(*args)
    from .library import window_attn_fwd
    return window_attn_fwd(*args)


def grid_transpose(t: torch.Tensor, win: int) -> torch.Tensor:
    """(B, H, W, ...) -> the block-transposed map whose contiguous
    (H // win, W // win) windows are the grid-attention groups: element
    (b, i * nbh + a, j * nbw + c) is t[b, a * win + i, c * win + j].
    Requires H % win == 0 and W % win == 0."""
    b, h, w = t.shape[:3]
    nbh, nbw = h // win, w // win
    rest = tuple(t.shape[3:])
    t = t.reshape((b, nbh, win, nbw, win) + rest)
    t = t.permute((0, 2, 1, 4, 3) + tuple(range(5, 5 + len(rest))))
    return t.reshape((b, win * nbh, win * nbw) + rest)


def grid_untranspose(t: torch.Tensor, win: int) -> torch.Tensor:
    """Inverse of ``grid_transpose``."""
    b, h, w = t.shape[:3]
    nbh, nbw = h // win, w // win
    rest = tuple(t.shape[3:])
    t = t.reshape((b, win, nbh, win, nbw) + rest)
    t = t.permute((0, 2, 1, 4, 3) + tuple(range(5, 5 + len(rest))))
    return t.reshape((b, h, w) + rest)
