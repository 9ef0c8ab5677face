"""Window and grid attention in plain PyTorch (counterpart of
``window_attention_xla`` and ``_block_partition`` in
``memotr_tpu/ops/window_attn.py`` and ``models/windowed_encoder.py``).

One block of multi-head self-attention inside groups of a map padded to
window multiples: q = k = x + pos and v = x, projected with
``nn.MultiheadAttention``'s layout; logits / sqrt(head dim) plus a per-head
bias (n_heads, L, L); padded keys masked; a group whose keys are all
padding is opened instead (as the program does: its outputs are kept where
they lie inside the map); a float32 softmax, the value mix and the output
projection.  Groups are windows of ``win`` x ``win`` neighbours, or, for
grid attention, the tokens that share their place inside every window
(MaxViT's strided grid), whose members are the windows in row-major order.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def partition(t: torch.Tensor, win: int, grid: bool) -> torch.Tensor:
    """(B, H, W, ...) with H and W multiples of ``win`` -> (B * G, L, ...):
    windows (G = HW / win^2 groups of L = win^2) or grid groups (G = win^2
    groups of L = HW / win^2, member (a, c) the window in row a, column c)."""
    b, h, w = t.shape[:3]
    rest = tuple(t.shape[3:])
    nh, nw = h // win, w // win
    t = t.reshape((b, nh, win, nw, win) + rest)
    extra = tuple(range(5, 5 + len(rest)))
    if grid:
        t = t.permute((0, 2, 4, 1, 3) + extra)
        return t.reshape((b * win * win, nh * nw) + rest)
    t = t.permute((0, 1, 3, 2, 4) + extra)
    return t.reshape((b * nh * nw, win * win) + rest)


def merge(t: torch.Tensor, b: int, h: int, w: int, win: int,
          grid: bool) -> torch.Tensor:
    """Inverse of ``partition``: (B * G, L, C) -> (B, H, W, C)."""
    nh, nw, c = h // win, w // win, t.shape[-1]
    if grid:
        t = t.reshape(b, win, win, nh, nw, c).permute(0, 3, 1, 4, 2, 5)
    else:
        t = t.reshape(b, nh, nw, win, win, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, h, w, c)


def window_attention(x: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor,
                     in_proj_weight: torch.Tensor, in_proj_bias: torch.Tensor,
                     out_weight: torch.Tensor, out_bias: torch.Tensor,
                     bias: Optional[torch.Tensor], n_heads: int, win: int,
                     grid: bool) -> torch.Tensor:
    """x, pos (B, H, W, C) float32 with H and W multiples of ``win``; mask
    (B, H, W) bool, True = pad; bias (n_heads, L, L) or None.  Returns the
    attention output map (B, H, W, C), no residual."""
    b, h, w, c = x.shape
    q = partition(x + pos, win, grid)
    v = partition(x, win, grid)
    keys_pad = partition(mask, win, grid)                    # (G, L)
    keys_pad = keys_pad & ~keys_pad.all(dim=1, keepdim=True)
    g, l, _ = q.shape
    dh = c // n_heads
    wq, wk, wv = in_proj_weight.chunk(3)
    bq, bk, bv = in_proj_bias.chunk(3)

    def heads(t):
        return t.reshape(g, l, n_heads, dh).transpose(1, 2)

    qh = heads(F.linear(q, wq, bq))
    kh = heads(F.linear(q, wk, bk))
    vh = heads(F.linear(v, wv, bv))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) / dh ** 0.5
    if bias is not None:
        logits = logits + bias[None]
    logits = logits.masked_fill(keys_pad[:, None, None, :], float("-inf"))
    out = torch.matmul(torch.softmax(logits, dim=-1), vh)
    out = F.linear(out.transpose(1, 2).reshape(g, l, c), out_weight, out_bias)
    return merge(out, b, h, w, win, grid)
