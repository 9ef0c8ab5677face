"""MSDeformAttn layer: projections and sampling-location math around the op
(counterpart of ``memotr_tpu/models/msda_module.py``).

Sampling offsets and attention weights are computed in float32 whatever the
compute dtype: bilinear tap positions are precision-sensitive.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.msda import ms_deform_attn
from .layers import Linear


def ring_offset_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Directional ring init: head h points along angle 2*pi*h/M, scaled by
    point index (reference ms_deform_attn.py:72-80)."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)
    grid = grid / np.abs(grid).max(axis=-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


class MSDeformAttn(nn.Module):
    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.d_model = d_model
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = Linear(d_model, d_model, compute_dtype=dtype)
        self.output_proj = Linear(d_model, d_model, compute_dtype=dtype)
        with torch.no_grad():
            nn.init.zeros_(self.sampling_offsets.weight)
            self.sampling_offsets.bias.copy_(torch.from_numpy(
                ring_offset_bias(n_heads, n_levels, n_points)))
            nn.init.zeros_(self.attention_weights.weight)
            nn.init.zeros_(self.attention_weights.bias)
            for lin in (self.value_proj, self.output_proj):
                nn.init.xavier_uniform_(lin.weight)
                nn.init.zeros_(lin.bias)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                src: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                src_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """query (B, Lq, C); reference_points (B, Lq, L, 2|4) in [0, 1];
        src (B, sum(HW), C); src_padding_mask (B, sum(HW)) True = pad."""
        b, lq, _ = query.shape
        m, nl, p = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(src)
        if src_padding_mask is not None:
            value = value.masked_fill(src_padding_mask[..., None], 0.0)
        value = value.view(b, -1, m, self.d_model // m)

        q32 = query.float()
        offsets = self.sampling_offsets(q32).view(b, lq, m, nl, p, 2)
        attn = torch.softmax(self.attention_weights(q32).view(b, lq, m, nl * p),
                             dim=-1).view(b, lq, m, nl, p)

        ref = reference_points.float()
        if ref.shape[-1] == 2:
            wh = torch.tensor([[w, h] for (h, w) in spatial_shapes],
                              dtype=torch.float32, device=ref.device)
            loc = ref[:, :, None, :, None, :] + \
                offsets / wh[None, None, None, :, None, :]
        elif ref.shape[-1] == 4:
            loc = (ref[:, :, None, :, None, :2]
                   + offsets / p * ref[:, :, None, :, None, 2:] * 0.5)
        else:
            raise ValueError("reference_points last dim must be 2 or 4")

        out = ms_deform_attn(value.contiguous(), spatial_shapes,
                             loc.contiguous(), attn.contiguous())
        return self.output_proj(out)
