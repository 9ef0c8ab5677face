"""Multi-scale deformable attention (MSDA): the plain PyTorch version.

Deformable DETR's own PyTorch formulation (``ms_deform_attn_core_pytorch``):
each level is sampled with ``F.grid_sample(mode="bilinear",
padding_mode="zeros", align_corners=False)``, so a location ``loc`` in
[0, 1] samples pixel coordinate ``loc * size - 0.5`` and a corner outside
the map contributes zero; the samples are then weighted and summed.

Layouts:
  value               (B, sum(H_l*W_l), M, D)
  spatial_shapes      ((H_0, W_0), ...) python ints
  sampling_locations  (B, Lq, M, L, P, 2) as (x, y)
  attention_weights   (B, Lq, M, L, P)
  returns             (B, Lq, M*D)
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

Shapes = Sequence[Tuple[int, int]]


def ms_deform_attn_torch(value: torch.Tensor, spatial_shapes: Shapes,
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    b, _, m, d = value.shape
    _, lq, _, nl, p, _ = sampling_locations.shape
    assert nl == len(spatial_shapes)
    values = value.split([h * w for h, w in spatial_shapes], dim=1)
    grids = 2 * sampling_locations.to(value.dtype) - 1
    samples = []
    for lid, (h, w) in enumerate(spatial_shapes):
        v = values[lid].flatten(2).transpose(1, 2).reshape(b * m, d, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)  # (BM, Lq, P, 2)
        samples.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))      # (BM, D, Lq, P)
    aw = attention_weights.to(value.dtype).transpose(1, 2).reshape(
        b * m, 1, lq, nl * p)
    out = (torch.stack(samples, dim=-2).flatten(-2) * aw).sum(-1)
    return out.view(b, m * d, lq).transpose(1, 2).contiguous()


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Shapes,
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """The plain version on every device, with autograd's gradient."""
    return ms_deform_attn_torch(value, spatial_shapes, sampling_locations,
                                attention_weights)
