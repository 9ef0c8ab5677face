"""Small numeric helpers (counterpart of
``memotr_tpu/utils/misc.py``)."""
from __future__ import annotations

import math

import torch


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Clamped logit, as in the reference (utils/utils.py:61-74)."""
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)


def logits_to_scores(logits: torch.Tensor) -> torch.Tensor:
    """Class scores are plain sigmoids."""
    return torch.sigmoid(logits)


def pos_to_pos_embed(pos: torch.Tensor, num_pos_feats: int = 64,
                     temperature: float = 10000.0,
                     scale: float = 2 * math.pi) -> torch.Tensor:
    """(..., M) -> (..., M * num_pos_feats), interleaved sin/cos per
    coordinate: feature 2i is sin(pos / T^(2i/F)), 2i+1 is cos(...)."""
    pos = pos * scale
    dim_i = torch.arange(num_pos_feats, dtype=torch.float32, device=pos.device)
    dim_i = temperature ** (2.0 * torch.floor(dim_i / 2.0) / num_pos_feats)
    pe = pos[..., None] / dim_i                       # (..., M, F)
    pe = torch.stack([pe[..., 0::2].sin(), pe[..., 1::2].cos()], dim=-1)
    return pe.flatten(-3)
