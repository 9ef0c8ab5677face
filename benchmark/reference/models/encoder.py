"""Deformable transformer encoder (counterpart of
``memotr_tpu/models/encoder.py``).  Each layer: MSDA self-attention (pos
embed on the query side only) + residual + LayerNorm, then FFN + residual +
LayerNorm.  Reference points are scaled by the batch's valid ratios."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm, Linear
from .msda_module import MSDeformAttn


def encoder_reference_points(spatial_shapes: Sequence[Tuple[int, int]],
                             valid_ratios: torch.Tensor) -> torch.Tensor:
    """valid_ratios (B, L, 2) as (w, h) -> (B, sum(HW), L, 2) in [0, 1]."""
    dev = valid_ratios.device
    refs = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        ry = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
        rx = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        gy = gy.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * h)
        gx = gx.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * w)
        refs.append(torch.stack([gx, gy], dim=-1))
    ref = torch.cat(refs, dim=1)
    return ref[:, :, None] * valid_ratios[:, None]


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int,
                 n_points: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                      dtype=dtype)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, d_ffn, compute_dtype=dtype)
        self.linear2 = Linear(d_ffn, d_model, compute_dtype=dtype)
        self.norm2 = LayerNorm(d_model)

    def forward(self, src, pos, reference_points, spatial_shapes, padding_mask):
        q = src + pos.to(src.dtype)
        src2 = self.self_attn(q, reference_points, src, spatial_shapes,
                              padding_mask)
        src = self.norm1(src + src2)
        h = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + h)


class Encoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, d_ffn: int,
                 n_levels: int, n_heads: int, n_points: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, d_ffn, n_levels, n_heads, n_points, dtype)
            for _ in range(num_layers))

    def forward(self, src, spatial_shapes, valid_ratios, pos, padding_mask):
        reference_points = encoder_reference_points(spatial_shapes,
                                                    valid_ratios)
        out = src
        for layer in self.layers:
            out = layer(out, pos, reference_points, spatial_shapes,
                        padding_mask)
        return out
