"""Deformable transformer decoder with DAB anchors, merge-det-track layering
and iterative box refinement (counterpart of
``memotr_tpu/models/decoder.py``).

- Layers with ``lid < merge_det_track_layer`` process detection queries
  only: track queries are hidden from the self-attention keys, pass through
  unchanged, and keep their reference points.
- DAB query pos: sine embedding of the valid-ratio-scaled anchor ->
  ``ref_point_head``, scaled by ``query_scale(output)`` except at layer 0.
- Box refinement: ``ref = sigmoid(bbox_head(out) + logit(ref))``; the
  carried reference is detached.
- ``queries`` records each layer's *input* embedding.
- ``EXTRA_TRACK_ATTN``: merging layers first run a self-attention over the
  track queries alone (``track_attn``, then ``norm4``).  The JAX package
  creates it only in merging layers, and so does the port.
- Dropout follows each attention and the FFN's hidden activation and
  output, and acts on the attention probabilities; ``USE_CHECKPOINT``
  checkpoints each layer (``models/dropout.py``).

The per-layer class/box heads belong to the top-level model (reference
names ``class_embed.{i}`` / ``bbox_embed.{i}``); the decoder holds the box
heads as ``bbox_embed`` too, the alias the reference state dict carries, and
gets the class heads as an argument.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.misc import inverse_sigmoid, pos_to_pos_embed
from .dropout import Dropout, run_layer
from .layers import MLP, LayerNorm, Linear, MultiheadAttention
from .msda_module import MSDeformAttn


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int,
                 n_points: int, n_det_queries: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 track_attn: bool = False):
        super().__init__()
        self.n_det = n_det_queries
        if track_attn:
            self.track_attn = MultiheadAttention(d_model, n_heads,
                                                 dtype=dtype, dropout=dropout)
            self.norm4 = LayerNorm(d_model)
            self.dropout_track = Dropout(dropout)
        else:
            self.track_attn = None
        self.self_attn = MultiheadAttention(d_model, n_heads, dtype=dtype,
                                            dropout=dropout)
        self.norm2 = LayerNorm(d_model)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                       dtype=dtype)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, d_ffn, compute_dtype=dtype)
        self.linear2 = Linear(d_ffn, d_model, compute_dtype=dtype)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.dropout4 = Dropout(dropout)

    def forward(self, tgt, query_pos, reference_points_input, src,
                spatial_shapes, query_mask, src_padding_mask,
                merge_det_track: bool):
        """tgt/query_pos (B, Nq, C); reference_points_input (B, Nq, L, 2|4);
        query_mask (B, Nq) True = dead slot."""
        nd = self.n_det
        tgt_in = tgt
        key_mask = query_mask
        if not merge_det_track:
            key_mask = query_mask.clone()
            key_mask[:, nd:] = True

        if self.track_attn is not None and merge_det_track:
            qk_t = (tgt + query_pos.to(tgt.dtype))[:, nd:]
            t2 = self.track_attn(qk_t, qk_t, tgt[:, nd:],
                                 key_padding_mask=query_mask[:, nd:])
            t = self.norm4(tgt[:, nd:] + self.dropout_track(t2))
            # JAX's concatenate promotes the detection rows to float32
            dt = torch.promote_types(tgt.dtype, t.dtype)
            tgt = torch.cat([tgt[:, :nd].to(dt), t.to(dt)], dim=1)

        qk = tgt + query_pos.to(tgt.dtype)
        tgt2 = self.self_attn(qk, qk, tgt, key_padding_mask=key_mask)
        tgt = self.norm2(tgt + self.dropout2(tgt2))
        tgt2 = self.cross_attn(tgt + query_pos.to(tgt.dtype),
                               reference_points_input, src, spatial_shapes,
                               src_padding_mask)
        tgt = self.norm1(tgt + self.dropout1(tgt2))
        h = self.linear2(self.dropout3(F.relu(self.linear1(tgt))))
        tgt = self.norm3(tgt + self.dropout4(h))
        if not merge_det_track:
            tgt = torch.cat([tgt[:, :nd], tgt_in[:, nd:].to(tgt.dtype)], dim=1)
        return tgt


def bbox_head(d_model: int, wh_bias: float,
              dtype: torch.dtype = torch.float32) -> MLP:
    """3-layer box MLP; last layer zero-init and run in float32."""
    mlp = MLP(d_model, d_model, 4, 3, dtype=dtype)
    last = mlp.layers[-1]
    last.compute_dtype = torch.float32
    with torch.no_grad():
        last.weight.zero_()
        last.bias.copy_(torch.tensor([0.0, 0.0, wh_bias, wh_bias]))
    return mlp


class Decoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, d_ffn: int,
                 n_levels: int, n_heads: int, n_points: int,
                 n_det_queries: int = 300, merge_det_track_layer: int = 0,
                 use_dab: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 extra_track_attn: bool = False,
                 use_checkpoint: bool = False):
        super().__init__()
        self.d_model = d_model
        self.n_det = n_det_queries
        self.merge_det_track_layer = merge_det_track_layer
        self.use_dab = use_dab
        self.use_checkpoint = use_checkpoint
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, d_ffn, n_levels, n_heads, n_points,
                         n_det_queries, dtype, dropout,
                         track_attn=extra_track_attn
                         and lid >= merge_det_track_layer)
            for lid in range(num_layers))
        if use_dab:
            self.ref_point_head = MLP(2 * d_model, d_model, d_model, 2,
                                      dtype=dtype)
            self.query_scale = MLP(d_model, d_model, d_model, 2, dtype=dtype)
        self.bbox_embed: Optional[nn.ModuleList] = None   # set by the model

    def forward(self, tgt: torch.Tensor, reference_points: torch.Tensor,
                src: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                valid_ratios: torch.Tensor, query_pos: Optional[torch.Tensor],
                query_mask: torch.Tensor, src_padding_mask: torch.Tensor,
                class_embed: nn.ModuleList) -> Dict[str, torch.Tensor]:
        """tgt (B, Nq, C); reference_points (B, Nq, 4) sigmoid space.
        Returns per-layer stacks ``outputs``/``refs``/``queries``/
        ``logits``/``boxes`` (L, B, Nq, .) and ``init_reference``."""
        nd = self.n_det
        output = tgt
        init_reference = reference_points
        ref = reference_points if self.use_dab else reference_points[..., :2]
        ref_backup = reference_points

        outputs, refs, queries, logits_l, boxes_l = [], [], [], [], []
        for lid, layer in enumerate(self.layers):
            merge = lid >= self.merge_det_track_layer
            if ref.shape[-1] == 4:
                vr = torch.cat([valid_ratios, valid_ratios], dim=-1)
                ref_input = ref[:, :, None, :] * vr[:, None, :, :]
            else:
                ref_input = ref[:, :, None, :] * valid_ratios[:, None, :, :]

            if self.use_dab:
                anchor_embed = pos_to_pos_embed(ref_input[:, :, 0, :],
                                                num_pos_feats=self.d_model // 2)
                raw_pos = self.ref_point_head(anchor_embed)
                qp = raw_pos if lid == 0 else self.query_scale(output) * raw_pos
            else:
                qp = query_pos

            queries.append(output)
            output = run_layer(layer, output, qp, ref_input, src,
                               spatial_shapes, query_mask, src_padding_mask,
                               merge, use_checkpoint=self.use_checkpoint)

            cls_logits = class_embed[lid](output.float())
            delta = self.bbox_embed[lid](output)
            if ref.shape[-1] == 4:
                box = torch.sigmoid(delta + inverse_sigmoid(ref))
            else:
                delta = torch.cat([delta[..., :2] + inverse_sigmoid(ref),
                                   delta[..., 2:]], dim=-1)
                box = torch.sigmoid(delta)

            new_ref = box.detach()
            if not merge:
                keep = ref if (self.use_dab and ref.shape[-1] == 4) \
                    else ref_backup
                new_ref = torch.cat([new_ref[:, :nd], keep[:, nd:]], dim=1)
            ref = new_ref

            outputs.append(output)
            refs.append(ref)
            logits_l.append(cls_logits)
            boxes_l.append(box)

        return {
            "outputs": torch.stack(outputs),
            "refs": torch.stack(refs),
            "queries": torch.stack([q.float() for q in queries]),
            "logits": torch.stack(logits_l),
            "boxes": torch.stack(boxes_l),
            "init_reference": init_reference,
        }
