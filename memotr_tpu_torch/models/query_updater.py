"""Long-term-memory query updater over the fixed ``(B, S)`` slot bank
(counterpart of ``memotr_tpu/models/query_updater.py``).

Per slot, gated by ``is_pos = max(sigmoid(logits)) > UPDATE_THRESH`` and
slot liveness: refresh ``ref_pts`` from the boxes, fuse short memory,
attend across slots to the long memory, update the query embedding, and
move the long memory by an EMA.  Dead slots are hidden from the memory
attention keys.  Parameter names follow the reference ``query_updater.*``.
Dropout (``models/dropout.py``) acts on the memory attention's
probabilities and output, inside both FFNs, and on the fused memory before
``query_feat_norm``, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.misc import inverse_sigmoid, logits_to_scores, pos_to_pos_embed
from .dropout import Dropout
from .layers import FFN, MLP, LayerNorm, Linear, MultiheadAttention


class QueryUpdater(nn.Module):
    def __init__(self, hidden_dim: int, ffn_dim: int, use_dab: bool = True,
                 update_threshold: float = 0.5,
                 long_memory_lambda: float = 0.01,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        c = hidden_dim
        self.hidden_dim = c
        self.use_dab = use_dab
        self.update_threshold = update_threshold
        self.long_memory_lambda = long_memory_lambda
        self.dtype = dtype
        self.confidence_weight_net = nn.Sequential(
            MLP(c, c, c, 2, dtype=dtype), nn.Sigmoid())
        self.short_memory_fusion = MLP(2 * c, 2 * c, c, 2, dtype=dtype)
        self.memory_attn = MultiheadAttention(c, 8, dtype=dtype,
                                              dropout=dropout)
        self.memory_norm = LayerNorm(c)
        self.memory_ffn = FFN(c, ffn_dim, dtype=dtype, dropout=dropout)
        self.query_feat_norm = LayerNorm(c)
        self.query_feat_ffn = FFN(c, ffn_dim, dtype=dtype, dropout=dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.query_pos_head = MLP(2 * c, c, c, 2, dtype=dtype)
        if not use_dab:
            self.linear_pos1 = Linear(c, c, compute_dtype=dtype)
            self.linear_pos2 = Linear(c, c, compute_dtype=dtype)
            self.norm_pos = LayerNorm(c)

    def forward(self, query_embed, ref_pts, logits, boxes, output_embed,
                last_output, long_memory, slot_mask) -> Dict[str, torch.Tensor]:
        """(B, S, ...) slot tensors; slot_mask (B, S) True = live.  Returns
        the updated query_embed, ref_pts, long_memory and last_output."""
        c, dt = self.hidden_dim, self.dtype
        scores = logits_to_scores(logits.float()).amax(dim=-1)
        gate = ((scores > self.update_threshold) & slot_mask)[..., None]

        ref_pts = torch.where(gate, inverse_sigmoid(boxes.detach()), ref_pts)
        query_pos = self.query_pos_head(
            pos_to_pos_embed(torch.sigmoid(ref_pts), num_pos_feats=c // 2))

        out_emb = output_embed.to(dt)
        last_out = last_output.to(dt)
        long_mem = long_memory.detach().to(dt)

        conf_w = self.confidence_weight_net(out_emb)
        short_memory = self.short_memory_fusion(
            torch.cat([conf_w * out_emb, last_out], dim=-1))
        tgt2 = self.memory_attn(short_memory + query_pos, long_mem + query_pos,
                                out_emb, key_padding_mask=~slot_mask)
        tgt = self.memory_ffn(self.memory_norm(out_emb + self.dropout1(tgt2)))
        query_feat = self.query_feat_norm(long_mem
                                          + self.dropout2(tgt.to(dt)))
        query_feat = self.query_feat_ffn(query_feat)

        lam = self.long_memory_lambda
        ema = (1.0 - lam) * long_mem + lam * out_emb
        new_long_memory = torch.where(gate, ema, long_memory)
        new_last_output = torch.where(gate, out_emb, last_output)

        if self.use_dab:
            new_query_embed = torch.where(gate, query_feat.float(), query_embed)
        else:
            feat_half = torch.where(gate, query_feat.float(), query_embed[..., c:])
            new_pos = self.linear_pos2(F.relu(self.linear_pos1(out_emb)))
            pos_half = self.norm_pos(query_embed[..., :c] + new_pos)
            pos_half = torch.where(gate, pos_half, query_embed[..., :c])
            new_query_embed = torch.cat([pos_half, feat_half], dim=-1)

        return {
            "query_embed": new_query_embed.float(),
            "ref_pts": ref_pts,
            "long_memory": new_long_memory.float(),
            "last_output": new_last_output.float(),
        }
