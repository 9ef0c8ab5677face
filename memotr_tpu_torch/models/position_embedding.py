"""Sine position embedding over padded-image masks (counterpart of
``memotr_tpu/models/position_embedding.py``; MeMOTR uses temperature 20)."""
from __future__ import annotations

import math

import torch


def sine_position_embedding(mask: torch.Tensor, num_pos_feats: int,
                            temperature: float = 20.0,
                            scale: float = 2 * math.pi) -> torch.Tensor:
    """mask (B, H, W) bool, True = pad -> (B, H, W, 2*num_pos_feats) f32."""
    not_mask = (~mask).to(torch.float32)
    y = torch.cumsum(not_mask, dim=1)
    x = torch.cumsum(not_mask, dim=2)
    eps = 1e-6
    y = (y - 0.5) / (y[:, -1:, :] + eps) * scale
    x = (x - 0.5) / (x[:, :, -1:] + eps) * scale

    dim_i = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_i = temperature ** (2.0 * torch.floor(dim_i / 2.0) / num_pos_feats)
    pos_x = x[..., None] / dim_i
    pos_y = y[..., None] / dim_i
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=-1).flatten(-2)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=-1).flatten(-2)
    return torch.cat([pos_y, pos_x], dim=-1)
