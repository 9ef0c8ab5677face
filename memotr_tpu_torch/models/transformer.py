"""Deformable transformer: level flattening + encoder + decoder
(counterpart of ``memotr_tpu/models/transformer.py``, deformable encoder
only; the windowed, conv and hybrid encoders are later slices of the port,
see ROADMAP.md)."""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from .decoder import Decoder
from .encoder import Encoder


def valid_ratios_from_masks(masks: List[torch.Tensor]) -> torch.Tensor:
    """Per-level (B, H, W) True = pad -> (B, L, 2) as (w_ratio, h_ratio)."""
    ratios = []
    for m in masks:
        _, h, w = m.shape
        valid_h = (~m[:, :, 0]).sum(dim=1).float()
        valid_w = (~m[:, 0, :]).sum(dim=1).float()
        ratios.append(torch.stack([valid_w / w, valid_h / h], dim=-1))
    return torch.stack(ratios, dim=1)


class DeformableTransformer(nn.Module):
    def __init__(self, d_model: int = 256, d_ffn: int = 1024,
                 n_levels: int = 4, n_heads: int = 8, n_enc_points: int = 4,
                 n_dec_points: int = 4, n_enc_layers: int = 6,
                 n_dec_layers: int = 6, n_det_queries: int = 300,
                 merge_det_track_layer: int = 0, use_dab: bool = True,
                 encoder_type: str = "deformable",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if encoder_type != "deformable":
            raise NotImplementedError(
                f"ENCODER_TYPE={encoder_type!r} is not ported to PyTorch yet "
                "(ROADMAP.md, queue 1: slice 2)")
        self.use_dab = use_dab
        self.dtype = dtype
        self.level_embed = nn.Parameter(torch.randn(n_levels, d_model))
        self.encoder = Encoder(n_enc_layers, d_model, d_ffn, n_levels,
                               n_heads, n_enc_points, dtype)
        self.decoder = Decoder(n_dec_layers, d_model, d_ffn, n_levels,
                               n_heads, n_dec_points, n_det_queries,
                               merge_det_track_layer, use_dab, dtype)

    def forward(self, srcs: List[torch.Tensor], masks: List[torch.Tensor],
                pos_embeds: List[torch.Tensor], query_embed: torch.Tensor,
                ref_pts: torch.Tensor, query_mask: torch.Tensor,
                class_embed: nn.ModuleList) -> Dict[str, torch.Tensor]:
        """srcs (B, C, H, W) per level; masks (B, H, W) True = pad;
        pos_embeds (B, H, W, C); query_embed (B, Nq, C or 2C); ref_pts
        (B, Nq, 4) logit space; query_mask (B, Nq) True = dead slot."""
        spatial_shapes = tuple((s.shape[2], s.shape[3]) for s in srcs)
        src_flat = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs],
                             dim=1).contiguous()
        mask_flat = torch.cat([m.flatten(1) for m in masks], dim=1)
        pos_flat = torch.cat(
            [(p + self.level_embed[i]).flatten(1, 2)
             for i, p in enumerate(pos_embeds)], dim=1)
        valid_ratios = valid_ratios_from_masks(masks)

        memory = self.encoder(src_flat, spatial_shapes, valid_ratios,
                              pos_flat, mask_flat)

        if self.use_dab:
            tgt, query_pos = query_embed, None
        else:
            query_pos, tgt = torch.chunk(query_embed, 2, dim=-1)
            query_pos = query_pos.to(self.dtype)
        reference_points = torch.sigmoid(ref_pts.float())
        return self.decoder(tgt.to(self.dtype), reference_points, memory,
                            spatial_shapes, valid_ratios, query_pos,
                            query_mask, mask_flat, class_embed)
