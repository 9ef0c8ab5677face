"""``ENCODER_TYPE: windowed``: alternating window and grid attention with a
continuous position bias, LePE and fusion across levels (counterpart of
``memotr_tpu/models/windowed_encoder.py``), in plain PyTorch
(``ops/window_attn.py``): no kernel, and the bias tables computed anew at
every call.

Layer i attends inside windows for even i and across the grid for odd i.
Per level: a 3x3 depthwise convolution of the map with its padded pixels
zeroed, added (LePE, ``WINDOWED_LEPE``); attention on the map padded to
window multiples, with a bias of 16 * sigmoid of an MLP over the
log-scaled offsets between group members (``WINDOWED_RELPOS``; one table
for the window layers' levels, one a level for the grid layers, from the
layer's MLP or the encoder's with ``WINDOWED_SHARED_CPB``); residuals with
post-norm (or pre-norm and a final norm, ``WINDOWED_PRENORM``) and a ReLU
FFN.  Then the levels are fused: top-down, each level adds the mixed
nearest upsample of the coarser one (already fused), from the coarsest
down; bottom-up (``WINDOWED_BOTTOMUP``), each level adds the mixed 2x2 mean
of the finer one (already fused), zero-padded first where it is not twice
as large.

Parameter names are the program's: ``layers.<i>.win_attn.{in_proj_weight,
in_proj_bias, out_proj}``, ``lepe_dwconv``, ``cpb_mlp1/2``, ``norm1/2``,
``linear1/2``, ``topdown_mix``, ``bottomup_mix``, ``final_norm``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.window_attn import window_attention
from ..layers import LayerNorm, Linear, MultiheadAttention
from ..resnet import Conv2d

# the program's defaults of the options (``memotr_tpu_torch/config.py``)
DEFAULTS = {"WINDOW_SIZE": 8, "WINDOWED_LEPE": True,
            "WINDOWED_BOTTOMUP": True, "WINDOWED_RELPOS": True,
            "WINDOWED_PRENORM": False, "WINDOWED_SHARED_CPB": False}
CPB_HIDDEN = 64
Shapes = Sequence[Tuple[int, int]]


def option(config: dict, key: str):
    value = config.get(key)
    return DEFAULTS[key] if value is None else value


def build(config: dict, dtype: torch.dtype) -> "WindowedEncoder":
    return WindowedEncoder(
        config["NUM_ENC_LAYERS"], config["HIDDEN_DIM"], config["FFN_DIM"],
        config["NUM_HEADS"], config["NUM_FEATURE_LEVELS"],
        int(option(config, "WINDOW_SIZE")),
        bool(option(config, "WINDOWED_LEPE")),
        bool(option(config, "WINDOWED_BOTTOMUP")),
        bool(option(config, "WINDOWED_RELPOS")),
        bool(option(config, "WINDOWED_PRENORM")),
        bool(option(config, "WINDOWED_SHARED_CPB")), dtype)


# ------------------------------------------------------------ position bias
def bias_table(cpb1: nn.Linear, cpb2: nn.Linear, n_h: int, n_w: int,
               scale: int) -> torch.Tensor:
    """The (n_heads, L, L) bias of an (n_h, n_w) grid of L members, members
    ``scale`` pixels apart: 16 * sigmoid(MLP(offset)), the offset (dy, dx)
    in pixels as sign * log(1 + |d|) / log(1 + 1024)."""
    dev = cpb1.weight.device
    dy = torch.arange(-(n_h - 1), n_h, dtype=torch.float64, device=dev)
    dx = torch.arange(-(n_w - 1), n_w, dtype=torch.float64, device=dev)
    off = torch.stack(torch.meshgrid(dy, dx, indexing="ij"), -1) * scale
    off = torch.sign(off) * torch.log1p(off.abs()) / math.log1p(1024.0)
    table = 16.0 * torch.sigmoid(cpb2(F.relu(cpb1(off.float()))))
    my = torch.arange(n_h, device=dev).repeat_interleave(n_w)
    mx = torch.arange(n_w, device=dev).repeat(n_h)
    ry = my[:, None] - my[None, :] + n_h - 1
    rx = mx[:, None] - mx[None, :] + n_w - 1
    return table[ry, rx].permute(2, 0, 1)


def padded(n: int, win: int) -> int:
    return n + (-n) % win


def level_tables(cpb1: nn.Linear, cpb2: nn.Linear, shapes: Shapes, win: int,
                 grid: bool) -> List[torch.Tensor]:
    """One table a level: windows of win x win pixels, or the grid of the
    level's padded windows, ``win`` pixels apart."""
    if grid:
        return [bias_table(cpb1, cpb2, padded(h, win) // win,
                           padded(w, win) // win, win) for h, w in shapes]
    table = bias_table(cpb1, cpb2, win, win, 1)
    return [table for _ in shapes]


# ------------------------------------------------------------------- fusion
def upsample_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, h0, w0, C) -> (B, h, w, C): output pixel i takes source pixel
    floor((i + 1/2) h0 / h), in exact integers."""
    rows = (2 * torch.arange(h, device=x.device) + 1) * x.shape[1] // (2 * h)
    cols = (2 * torch.arange(w, device=x.device) + 1) * x.shape[2] // (2 * w)
    return x[:, rows][:, :, cols]


def pool_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The mean of each 2x2 block of ``x`` (B, 2h or less, 2w or less, C),
    zero-padded to (2h, 2w) first where it is not that size; the zeros
    count in the mean."""
    b, sh, sw, c = x.shape
    ph = 0 if sh == 2 * h else (-sh) % (2 * h)
    pw = 0 if sw == 2 * w else (-sw) % (2 * w)
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    x = x.reshape(b, h, x.shape[1] // h, w, x.shape[2] // w, c)
    return x.mean(dim=(2, 4))


def fuse(levels: List[torch.Tensor], topdown: Optional[nn.Module],
         bottomup: Optional[nn.Module]) -> List[torch.Tensor]:
    out = list(levels)
    for i in reversed(range(len(out) - 1)):
        up = upsample_nearest(out[i + 1], out[i].shape[1], out[i].shape[2])
        out[i] = out[i] + topdown(up)
    if bottomup is not None:
        for i in range(1, len(out)):
            down = pool_to(out[i - 1], out[i].shape[1], out[i].shape[2])
            out[i] = out[i] + bottomup(down)
    return out


# -------------------------------------------------------------------- layers
class WindowedLayer(nn.Module):
    def __init__(self, d_model: int, d_ffn: int, n_heads: int, n_levels: int,
                 win: int, grid: bool, lepe: bool, bottomup: bool,
                 relpos: bool, prenorm: bool, own_cpb: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.n_heads, self.win, self.grid = n_heads, win, grid
        self.relpos, self.prenorm = relpos, prenorm
        self.win_attn = MultiheadAttention(d_model, n_heads, dtype)
        if relpos and own_cpb:
            self.cpb_mlp1 = nn.Linear(2, CPB_HIDDEN)
            self.cpb_mlp2 = nn.Linear(CPB_HIDDEN, n_heads, bias=False)
        self.lepe_dwconv = Conv2d(d_model, d_model, 3, padding=1,
                                  groups=d_model, compute_dtype=dtype) \
            if lepe else None
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, d_ffn, compute_dtype=dtype)
        self.linear2 = Linear(d_ffn, d_model, compute_dtype=dtype)
        self.norm2 = LayerNorm(d_model)
        self.topdown_mix = Linear(d_model, d_model, compute_dtype=dtype) \
            if n_levels > 1 else None
        self.bottomup_mix = Linear(d_model, d_model, compute_dtype=dtype) \
            if n_levels > 1 and bottomup else None

    def tables(self, shapes: Shapes) -> Optional[List[torch.Tensor]]:
        if not self.relpos:
            return None
        return level_tables(self.cpb_mlp1, self.cpb_mlp2, shapes, self.win,
                            self.grid)

    def attend(self, x: torch.Tensor, m: torch.Tensor, pos: torch.Tensor,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
        _, h, w, _ = x.shape
        ph, pw = (-h) % self.win, (-w) % self.win
        xp = F.pad(x, (0, 0, 0, pw, 0, ph))
        pp = F.pad(pos.to(x.dtype), (0, 0, 0, pw, 0, ph))
        mp = F.pad(m, (0, pw, 0, ph), value=True)
        att = self.win_attn
        y = window_attention(xp, pp, mp, att.in_proj_weight,
                             att.in_proj_bias, att.out_proj.weight,
                             att.out_proj.bias, bias, self.n_heads, self.win,
                             self.grid)
        return y[:, :h, :w]

    def forward(self, levels: List[torch.Tensor], masks: List[torch.Tensor],
                poss: List[torch.Tensor],
                tables: Optional[List[torch.Tensor]]) -> List[torch.Tensor]:
        out = []
        for lvl, (x, m, pos) in enumerate(zip(levels, masks, poss)):
            if self.lepe_dwconv is not None:
                xz = x.masked_fill(m[..., None], 0.0).permute(0, 3, 1, 2)
                x = x + self.lepe_dwconv(xz).permute(0, 2, 3, 1)
            xa = self.norm1(x) if self.prenorm else x
            y = self.attend(xa, m, pos, None if tables is None
                            else tables[lvl])
            if self.prenorm:
                x = x + y
                x = x + self.linear2(F.relu(self.linear1(self.norm2(x))))
            else:
                x = self.norm1(x + y)
                x = self.norm2(x + self.linear2(F.relu(self.linear1(x))))
            out.append(x)
        return fuse(out, self.topdown_mix, self.bottomup_mix)


def split(flat: torch.Tensor, shapes: Shapes) -> List[torch.Tensor]:
    """(B, sum(HW), ...) -> per level (B, H, W, ...)."""
    sizes = [h * w for h, w in shapes]
    return [t.reshape((t.shape[0], h, w) + tuple(t.shape[2:]))
            for t, (h, w) in zip(flat.split(sizes, dim=1), shapes)]


class WindowedEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, d_ffn: int,
                 n_heads: int, n_levels: int, win: int, lepe: bool,
                 bottomup: bool, relpos: bool, prenorm: bool,
                 shared_cpb: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.shared = relpos and shared_cpb
        self.layers = nn.ModuleList(
            WindowedLayer(d_model, d_ffn, n_heads, n_levels, win, i % 2 == 1,
                          lepe, bottomup, relpos, prenorm, not shared_cpb,
                          dtype)
            for i in range(num_layers))
        if self.shared:
            self.cpb_mlp1 = nn.Linear(2, CPB_HIDDEN)
            self.cpb_mlp2 = nn.Linear(CPB_HIDDEN, n_heads, bias=False)
        self.final_norm = LayerNorm(d_model) if prenorm else None

    def forward(self, src: torch.Tensor, spatial_shapes: Shapes,
                valid_ratios: torch.Tensor, pos: torch.Tensor,
                padding_mask: torch.Tensor) -> torch.Tensor:
        """The deformable encoder's call; ``valid_ratios`` is not used."""
        levels = split(src, spatial_shapes)
        masks = split(padding_mask, spatial_shapes)
        poss = split(pos, spatial_shapes)
        for layer in self.layers:
            if self.shared:
                tables = level_tables(self.cpb_mlp1, self.cpb_mlp2,
                                      spatial_shapes, layer.win, layer.grid)
            else:
                tables = layer.tables(spatial_shapes)
            levels = layer(levels, masks, poss, tables)
        if self.final_norm is not None:
            levels = [self.final_norm(x) for x in levels]
        return torch.cat([x.flatten(1, 2) for x in levels], dim=1)
