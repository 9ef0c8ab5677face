"""Windowed encoder: alternating window / grid attention with a continuous
position bias, LePE and cross-level fusion (counterpart of
``memotr_tpu/models/windowed_encoder.py``, selected with ``ENCODER_TYPE:
windowed``).

Each layer, per pyramid level: a 3x3 depthwise-conv positional residual
(LePE) on the map with padded pixels zeroed; window attention (even layers)
or grid attention (odd layers) through the fused kernel K2
(``ops/window_attn.py``) on the map padded to window multiples; post-norm
(or pre-norm) residuals and FFN; then bidirectional cross-level fusion.
Attention takes the fused route (JAX ``windowed_encoder.py:255-296``)
wherever dropout is off: streaming, evaluation, serving, a distillation
teacher, and training at ``DROPOUT`` 0.  K2 has no dropout, so a training
step at ``DROPOUT`` > 0 takes the composed route instead: the plain
version of K2 with dropout on the attention probabilities, the function
of JAX's ``MultiheadAttention`` route (``windowed_encoder.py:221``), which
JAX takes whenever ``dropout > 0``.  The configuration sets the route;
it is not a fallback.  ``WINDOWED_ATTN_IMPL`` is a TPU dispatch knob the
port ignores.  Dropout also follows the attention and the FFN's hidden
activation and output, per level; ``USE_CHECKPOINT`` checkpoints each
layer (``models/dropout.py``).

Parameter names are those of the JAX trees under the port's module names:
``layers.<i>.win_attn.{in_proj_weight, in_proj_bias, out_proj}``,
``lepe_dwconv``, ``cpb_mlp1/2`` (per layer, or once on the encoder with
``WINDOWED_SHARED_CPB``), ``norm1/2``, ``linear1/2``, ``topdown_mix``,
``bottomup_mix`` and ``final_norm``, so ``checkpoint/convert.py`` maps a
JAX-initialised model onto it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.window_attn import (grid_transpose, grid_untranspose,
                               window_attention, window_attention_torch)
from ..utils.misc import host_to_device
from .dropout import Dropout, run_layer
from .layers import LayerNorm, Linear, MultiheadAttention
from .resnet import Conv2d

Shapes = Sequence[Tuple[int, int]]
# per level, an (n_heads, L, L) bias table, or None without relative bias
LevelBiases = Optional[List[torch.Tensor]]


def relpos_table(n_h: int, n_w: int, scale: int) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """Relative-position geometry of an (n_h, n_w) member grid: ``coords``,
    the unique offsets ((2n_h-1)(2n_w-1), 2) log-scaled to about [-1, 1]
    (Swin-v2 continuous position bias), and ``index`` (L, L), each member
    pair's row in it.  ``scale`` turns member units into feature-map pixels
    (1 for window attention, the window size for grid attention)."""
    dy = np.arange(-(n_h - 1), n_h)[:, None] * scale
    dx = np.arange(-(n_w - 1), n_w)[None, :] * scale
    coords = np.stack(np.broadcast_arrays(dy, dx), axis=-1).reshape(-1, 2)
    coords = np.sign(coords) * np.log1p(np.abs(coords)) / np.log1p(1024.0)
    yy, xx = np.meshgrid(np.arange(n_h), np.arange(n_w), indexing="ij")
    mem = np.stack([yy.ravel(), xx.ravel()], axis=-1)
    rel = mem[:, None] - mem[None, :]
    index = (rel[..., 0] + n_h - 1) * (2 * n_w - 1) + (rel[..., 1] + n_w - 1)
    return coords.astype(np.float32), index


def cpb_bias(cpb1: nn.Linear, cpb2: nn.Linear, n_h: int, n_w: int,
             scale: int) -> torch.Tensor:
    """Continuous position bias of an (n_h, n_w) member grid, (H, L, L)
    float32: an MLP over the log-scaled offsets, bounded by 16*sigmoid."""
    coords, index = relpos_table(n_h, n_w, scale)
    dev = cpb1.weight.device
    table = cpb2(F.relu(cpb1(host_to_device(coords, dev))))
    table = 16.0 * torch.sigmoid(table)                     # (T, H)
    bias = table[host_to_device(index, dev)]                # (L, L, H)
    return bias.permute(2, 0, 1).contiguous()


def grid_members(h: int, w: int, win: int) -> Tuple[int, int]:
    """Members per grid group of an (h, w) level padded to ``win``."""
    return (h + (-h) % win) // win, (w + (-w) % win) // win


def nearest_upsample(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, h0, w0, C) -> (B, h, w, C), nearest with half-pixel centres:
    source index floor((i + 0.5) * in / out) in float32, as
    ``jax.image.resize(..., "nearest")`` computes it."""
    def index(n_in, n_out):
        pos = (torch.arange(n_out, dtype=torch.float32, device=x.device)
               + 0.5) * n_in / n_out
        return torch.floor(pos).long()
    return x[:, index(x.shape[1], h)][:, :, index(x.shape[2], w)]


def level_biases(cpb1: nn.Linear, cpb2: nn.Linear, spatial_shapes: Shapes,
                 window: int, grid: bool) -> List[torch.Tensor]:
    """Per-level bias tables of one layer: window attention shares one
    (window x window) table across levels; grid attention has one per level,
    its members whole windows (scale = window)."""
    if grid:
        return [cpb_bias(cpb1, cpb2, *grid_members(h, w, window), window)
                for h, w in spatial_shapes]
    return [cpb_bias(cpb1, cpb2, window, window, 1)] * len(spatial_shapes)


def cross_level_fuse(out: List[torch.Tensor], topdown: Optional[nn.Module],
                     bottomup: Optional[nn.Module]) -> List[torch.Tensor]:
    """Top-down (nearest-upsampled coarser level, mixed and added), then
    bottom-up (2x2-average-pooled finer level, mixed and added).  A finer
    level that is not exactly twice the coarser one is zero-padded first,
    and the zeros are averaged in (JAX ``windowed_encoder.py:155-165``)."""
    fused = list(out)
    for i in range(len(fused) - 2, -1, -1):
        up = nearest_upsample(fused[i + 1], fused[i].shape[1],
                              fused[i].shape[2])
        fused[i] = fused[i] + topdown(up)
    if bottomup is not None:
        for i in range(1, len(fused)):
            src = fused[i - 1]
            th, tw = fused[i].shape[1], fused[i].shape[2]
            ph = (-src.shape[1]) % (2 * th) if src.shape[1] != 2 * th else 0
            pw = (-src.shape[2]) % (2 * tw) if src.shape[2] != 2 * tw else 0
            if ph or pw:
                src = F.pad(src, (0, 0, 0, pw, 0, ph))
            down = src.reshape(src.shape[0], th, src.shape[1] // th, tw,
                               src.shape[2] // tw, src.shape[-1])
            fused[i] = fused[i] + bottomup(down.mean(dim=(2, 4)))
    return fused


def split_levels(flat: torch.Tensor, spatial_shapes: Shapes
                 ) -> List[torch.Tensor]:
    """(B, sum(HW), ...) -> per-level (B, H, W, ...)."""
    out, start = [], 0
    for h, w in spatial_shapes:
        out.append(flat[:, start:start + h * w].reshape(
            (flat.shape[0], h, w) + tuple(flat.shape[2:])))
        start += h * w
    return out


def flatten_levels(levels: List[torch.Tensor]) -> torch.Tensor:
    """Per-level (B, H, W, ...) -> (B, sum(HW), ...)."""
    return torch.cat([t.flatten(1, 2) for t in levels], dim=1)


class WindowedEncoderLayer(nn.Module):
    """One windowed layer over ``n_levels`` pyramid levels (``grid``:
    grid attention instead of window attention).  ``own_cpb`` holds the
    layer's CPB MLP; without it (shared CPB) the caller passes the
    tables."""

    def __init__(self, d_model: int, d_ffn: int, n_heads: int,
                 n_levels: int, window: int = 8, grid: bool = False,
                 use_lepe: bool = True, use_bottomup: bool = True,
                 use_relpos: bool = True, prenorm: bool = False,
                 own_cpb: bool = True, relpos_hidden: int = 64,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.n_heads, self.window, self.grid = n_heads, window, grid
        self.use_relpos, self.prenorm, self.dtype = use_relpos, prenorm, dtype
        self.win_attn = MultiheadAttention(d_model, n_heads, dtype,
                                           dropout=dropout)
        self.dropout_attn = Dropout(dropout)
        self.dropout_hidden = Dropout(dropout)
        self.dropout_ffn = Dropout(dropout)
        if use_relpos and own_cpb:
            self.cpb_mlp1 = nn.Linear(2, relpos_hidden)
            self.cpb_mlp2 = nn.Linear(relpos_hidden, n_heads, bias=False)
        self.lepe_dwconv = Conv2d(d_model, d_model, 3, padding=1,
                                  groups=d_model, compute_dtype=dtype) \
            if use_lepe else None
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, d_ffn, compute_dtype=dtype)
        self.linear2 = Linear(d_ffn, d_model, compute_dtype=dtype)
        self.norm2 = LayerNorm(d_model)
        # the JAX layer creates the mixes only where fusion runs
        multi = n_levels > 1
        self.topdown_mix = Linear(d_model, d_model, compute_dtype=dtype) \
            if multi else None
        self.bottomup_mix = Linear(d_model, d_model, compute_dtype=dtype) \
            if multi and use_bottomup else None

    def bias_tables(self, spatial_shapes: Shapes) -> LevelBiases:
        """Per-level bias tables from this layer's own CPB MLP; None
        without relative bias."""
        if not self.use_relpos:
            return None
        return level_biases(self.cpb_mlp1, self.cpb_mlp2, spatial_shapes,
                            self.window, self.grid)

    def _attend(self, x: torch.Tensor, m: torch.Tensor, pos: torch.Tensor,
                bias: Optional[torch.Tensor], lvl: int) -> torch.Tensor:
        """Pad to window multiples, (grid: block-transpose), K2 (or, with
        dropout active, its composed route), crop."""
        b, h, w, _ = x.shape
        win, dt = self.window, self.dtype
        ph, pw = (-h) % win, (-w) % win
        xp = F.pad(x.to(dt), (0, 0, 0, pw, 0, ph))
        pp = F.pad(pos.to(dt), (0, 0, 0, pw, 0, ph))
        mp = F.pad(m, (0, pw, 0, ph), value=True)
        wh = ww = win
        if self.grid:
            wh, ww = grid_members(h, w, win)
            xp, pp, mp = (grid_transpose(t, win).contiguous()
                          for t in (xp, pp, mp))
        att = self.win_attn
        args = (xp.contiguous(), pp.contiguous(), mp, att.in_proj_weight,
                att.in_proj_bias, att.out_proj.weight, att.out_proj.bias,
                bias, self.n_heads, wh, ww)
        if att.dropout.active():
            y = window_attention_torch(
                *args, attn_dropout=lambda a: att.dropout(a, call=lvl))
        else:
            y = window_attention(*args)
        if self.grid:
            y = grid_untranspose(y, win)
        return y[:, :h, :w]

    def forward(self, levels: List[torch.Tensor], masks: List[torch.Tensor],
                poss: List[torch.Tensor], biases: LevelBiases
                ) -> List[torch.Tensor]:
        """levels (B, H_l, W_l, C); masks (B, H_l, W_l) True = pad; poss
        (B, H_l, W_l, C); biases from ``bias_tables`` (or the eval
        cache)."""
        out = []
        for lvl, (x, m, pos) in enumerate(zip(levels, masks, poss)):
            if self.lepe_dwconv is not None:
                xz = x.masked_fill(m[..., None], 0.0)
                x = x + self.lepe_dwconv(xz.permute(0, 3, 1, 2)
                                         ).permute(0, 2, 3, 1)
            xa = self.norm1(x).to(x.dtype) if self.prenorm else x
            y = self.dropout_attn(self._attend(
                xa, m, pos, biases[lvl] if biases is not None else None, lvl),
                call=lvl)
            if self.prenorm:
                x = x + y
                h = self.linear1(self.norm2(x).to(x.dtype))
            else:
                x = self.norm1(x + y)
                h = self.linear1(x)
            f = self.linear2(self.dropout_hidden(F.relu(h), call=lvl))
            x = x + self.dropout_ffn(f, call=lvl)
            if not self.prenorm:
                x = self.norm2(x)
            out.append(x)
        return cross_level_fuse(out, self.topdown_mix, self.bottomup_mix)


class WindowedEncoder(nn.Module):
    """Drop-in replacement for the deformable ``Encoder``: layer i is a
    window layer for even i and a grid layer for odd i."""

    def __init__(self, num_layers: int, d_model: int, d_ffn: int,
                 n_heads: int, n_levels: int, window: int = 8,
                 use_lepe: bool = True, use_bottomup: bool = True,
                 use_relpos: bool = True, prenorm: bool = False,
                 shared_cpb: bool = False,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 use_checkpoint: bool = False):
        super().__init__()
        self.shared = use_relpos and shared_cpb
        self.use_checkpoint = use_checkpoint
        self.layers = nn.ModuleList(
            WindowedEncoderLayer(d_model, d_ffn, n_heads, n_levels, window,
                                 grid=i % 2 == 1, use_lepe=use_lepe,
                                 use_bottomup=use_bottomup,
                                 use_relpos=use_relpos, prenorm=prenorm,
                                 own_cpb=not shared_cpb, dtype=dtype,
                                 dropout=dropout)
            for i in range(num_layers))
        if self.shared:
            self.cpb_mlp1 = nn.Linear(2, 64)
            self.cpb_mlp2 = nn.Linear(64, n_heads, bias=False)
        self.final_norm = LayerNorm(d_model) if prenorm else None

    def bias_tables(self, spatial_shapes: Shapes) -> List[LevelBiases]:
        """Every layer's per-level bias tables (what the eval cache keeps
        for a sequence); they depend on the parameters and shapes only."""
        if not self.shared:
            return [layer.bias_tables(spatial_shapes) for layer in self.layers]
        # shared CPB: one window table set and one grid table set
        win = self.layers[0].window
        tables = {grid: level_biases(self.cpb_mlp1, self.cpb_mlp2,
                                     spatial_shapes, win, grid)
                  for grid in {layer.grid for layer in self.layers}}
        return [tables[layer.grid] for layer in self.layers]

    def forward(self, src: torch.Tensor, spatial_shapes: Shapes,
                valid_ratios: torch.Tensor, pos: torch.Tensor,
                padding_mask: torch.Tensor,
                bias_tables: Optional[List[LevelBiases]] = None
                ) -> torch.Tensor:
        """Same signature as ``Encoder.forward``; ``bias_tables`` are the
        eval cache's (``bias_tables`` of this module), else computed."""
        del valid_ratios
        levels = split_levels(src, spatial_shapes)
        masks = split_levels(padding_mask, spatial_shapes)
        poss = split_levels(pos, spatial_shapes)
        if bias_tables is None:
            bias_tables = self.bias_tables(spatial_shapes)
        for layer, biases in zip(self.layers, bias_tables):
            levels = run_layer(layer, levels, masks, poss, biases,
                               use_checkpoint=self.use_checkpoint)
        if self.final_norm is not None:
            levels = [self.final_norm(lv).to(lv.dtype) for lv in levels]
        return flatten_levels(levels)
