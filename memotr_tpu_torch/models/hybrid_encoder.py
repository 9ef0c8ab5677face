"""Hybrid encoder: windowed attention on the fine levels, exact deformable
attention on the coarse ones (counterpart of
``memotr_tpu/models/hybrid_encoder.py``, ``ENCODER_TYPE: hybrid``).

Each layer runs a ``WindowedEncoderLayer`` (``fine``, kernel K2) over the
levels below ``HYBRID_DEFORM_MIN_LEVEL`` and the deformable ``EncoderLayer``
(``coarse``, kernel K1) over the others, then fuses the whole pyramid
across levels, so both groups see each other every layer.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from .encoder import EncoderLayer, encoder_reference_points
from .layers import LayerNorm, Linear
from .windowed_encoder import (Shapes, WindowedEncoderLayer, cross_level_fuse,
                               flatten_levels, split_levels)


class HybridEncoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ffn: int, n_heads: int, n_points: int,
                 n_fine: int, n_coarse: int, window: int = 8,
                 grid: bool = False, use_lepe: bool = True,
                 use_relpos: bool = True, prenorm: bool = False,
                 use_bottomup: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fine = WindowedEncoderLayer(
            d_model, d_ffn, n_heads, n_fine, window, grid=grid,
            use_lepe=use_lepe, use_bottomup=use_bottomup,
            use_relpos=use_relpos, prenorm=prenorm, dtype=dtype)
        self.coarse = EncoderLayer(d_model, d_ffn, n_coarse, n_heads,
                                   n_points, dtype)
        self.topdown_mix = Linear(d_model, d_model, compute_dtype=dtype)
        self.bottomup_mix = Linear(d_model, d_model, compute_dtype=dtype) \
            if use_bottomup else None

    def forward(self, levels: List[torch.Tensor], masks: List[torch.Tensor],
                poss: List[torch.Tensor], coarse_ref_pts: torch.Tensor,
                coarse_shapes: Shapes) -> List[torch.Tensor]:
        """levels / masks / poss: the whole pyramid, fine first, as in
        ``WindowedEncoderLayer``; coarse_ref_pts (B, N_coarse, L_coarse, 2)."""
        n_fine = len(levels) - len(coarse_shapes)
        fine_shapes = [tuple(lv.shape[1:3]) for lv in levels[:n_fine]]
        fine = self.fine(levels[:n_fine], masks[:n_fine], poss[:n_fine],
                         self.fine.bias_tables(fine_shapes))
        src = self.coarse(flatten_levels(levels[n_fine:]), flatten_levels(poss[n_fine:]),
                          coarse_ref_pts, coarse_shapes,
                          flatten_levels(masks[n_fine:]))
        return cross_level_fuse(fine + split_levels(src, coarse_shapes),
                                self.topdown_mix, self.bottomup_mix)


class HybridEncoder(nn.Module):
    """Drop-in replacement for the deformable ``Encoder``: levels from
    ``deform_min_level`` on (at least one, and never the finest) are
    deformable."""

    def __init__(self, num_layers: int, d_model: int, d_ffn: int,
                 n_heads: int, n_levels: int, n_points: int = 4,
                 deform_min_level: int = 1, window: int = 8,
                 use_lepe: bool = True, use_bottomup: bool = True,
                 use_relpos: bool = True, prenorm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_fine = max(1, min(deform_min_level, n_levels - 1))
        self.layers = nn.ModuleList(
            HybridEncoderLayer(d_model, d_ffn, n_heads, n_points, self.n_fine,
                               n_levels - self.n_fine, window,
                               grid=i % 2 == 1, use_lepe=use_lepe,
                               use_relpos=use_relpos, prenorm=prenorm,
                               use_bottomup=use_bottomup, dtype=dtype)
            for i in range(num_layers))
        self.final_norm: Optional[nn.Module] = LayerNorm(d_model) \
            if prenorm else None

    def forward(self, src: torch.Tensor, spatial_shapes: Shapes,
                valid_ratios: torch.Tensor, pos: torch.Tensor,
                padding_mask: torch.Tensor) -> torch.Tensor:
        levels = split_levels(src, spatial_shapes)
        masks = split_levels(padding_mask, spatial_shapes)
        poss = split_levels(pos, spatial_shapes)
        coarse_shapes = tuple(spatial_shapes[self.n_fine:])
        coarse_refs = encoder_reference_points(
            coarse_shapes, valid_ratios[:, self.n_fine:])
        for layer in self.layers:
            levels = layer(levels, masks, poss, coarse_refs, coarse_shapes)
        if self.final_norm is not None:
            levels = [self.final_norm(lv).to(lv.dtype) for lv in levels]
        return flatten_levels(levels)
