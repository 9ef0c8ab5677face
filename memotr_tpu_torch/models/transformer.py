"""Deformable transformer: level flattening + encoder + decoder
(counterpart of ``memotr_tpu/models/transformer.py``).  The encoder is the
deformable one, the windowed one (``models/windowed_encoder.py``), the
hybrid one (``models/hybrid_encoder.py``) or the conv one
(``models/conv_encoder.py``)."""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from .conv_encoder import ConvEncoder
from .decoder import Decoder
from .encoder import Encoder
from .hybrid_encoder import HybridEncoder
from .windowed_encoder import WindowedEncoder


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
                 encoder_type: str = "deformable", window: int = 8,
                 use_lepe: bool = True, use_bottomup: bool = True,
                 use_relpos: bool = True, prenorm: bool = False,
                 shared_cpb: bool = False, deform_min_level: int = 1,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 extra_track_attn: bool = False,
                 use_checkpoint: bool = False):
        """``window`` .. ``deform_min_level``: the options of the windowed
        and hybrid encoders (``WINDOW_SIZE``, ``WINDOWED_*``,
        ``HYBRID_DEFORM_MIN_LEVEL``); ``dropout`` (``DROPOUT``),
        ``extra_track_attn`` (``EXTRA_TRACK_ATTN``) and ``use_checkpoint``
        (``USE_CHECKPOINT``) reach the encoder's and decoder's layers."""
        super().__init__()
        self.use_dab = use_dab
        self.dtype = dtype
        self.level_embed = nn.Parameter(torch.randn(n_levels, d_model))
        opts = dict(dtype=dtype, dropout=dropout,
                    use_checkpoint=use_checkpoint)
        win_opts = dict(window=window, use_lepe=use_lepe,
                        use_bottomup=use_bottomup, use_relpos=use_relpos,
                        prenorm=prenorm, **opts)
        if encoder_type == "deformable":
            self.encoder = Encoder(n_enc_layers, d_model, d_ffn, n_levels,
                                   n_heads, n_enc_points, **opts)
        elif encoder_type == "windowed":
            self.encoder = WindowedEncoder(n_enc_layers, d_model, d_ffn,
                                           n_heads, n_levels,
                                           shared_cpb=shared_cpb, **win_opts)
        elif encoder_type == "hybrid":
            self.encoder = HybridEncoder(n_enc_layers, d_model, d_ffn,
                                         n_heads, n_levels, n_enc_points,
                                         deform_min_level, **win_opts)
        elif encoder_type == "conv":
            self.encoder = ConvEncoder(n_enc_layers, d_model, d_ffn, n_levels,
                                       use_bottomup, **opts)
        else:
            raise ValueError(f"unknown ENCODER_TYPE {encoder_type!r}")
        self.decoder = Decoder(n_dec_layers, d_model, d_ffn, n_levels,
                               n_heads, n_dec_points, n_det_queries,
                               merge_det_track_layer, use_dab,
                               extra_track_attn=extra_track_attn, **opts)

    def forward(self, srcs: List[torch.Tensor], masks: List[torch.Tensor],
                pos_embeds: List[torch.Tensor], query_embed: torch.Tensor,
                ref_pts: torch.Tensor, query_mask: torch.Tensor,
                class_embed: nn.ModuleList,
                bias_tables: Optional[List] = None) -> Dict[str, torch.Tensor]:
        """srcs (B, C, H, W) per level; masks (B, H, W) True = pad;
        pos_embeds (B, H, W, C); query_embed (B, Nq, C or 2C); ref_pts
        (B, Nq, 4) logit space; query_mask (B, Nq) True = dead slot;
        bias_tables: the windowed encoder's cached CPB tables (eval
        cache), or None.  Returns the decoder's outputs plus ``memory``
        (B, S, C), the encoder's output over the flattened levels, and
        ``memory_mask`` (B, S), True = padding."""
        spatial_shapes = tuple((s.shape[2], s.shape[3]) for s in srcs)
        src_flat = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs],
                             dim=1).contiguous()
        mask_flat = torch.cat([m.flatten(1) for m in masks], dim=1)
        pos_flat = torch.cat(
            [(p + self.level_embed[i]).flatten(1, 2)
             for i, p in enumerate(pos_embeds)], dim=1)
        valid_ratios = valid_ratios_from_masks(masks)

        enc_args = (src_flat, spatial_shapes, valid_ratios, pos_flat,
                    mask_flat)
        memory = self.encoder(*enc_args) if bias_tables is None \
            else self.encoder(*enc_args, bias_tables=bias_tables)

        if self.use_dab:
            tgt, query_pos = query_embed, None
        else:
            query_pos, tgt = torch.chunk(query_embed, 2, dim=-1)
            query_pos = query_pos.to(self.dtype)
        reference_points = torch.sigmoid(ref_pts.float())
        dec = self.decoder(tgt.to(self.dtype), reference_points, memory,
                           spatial_shapes, valid_ratios, query_pos,
                           query_mask, mask_flat, class_embed)
        # the encoder's memory, for feature distillation (engine/trainer.py)
        return dict(dec, memory=memory, memory_mask=mask_flat)
