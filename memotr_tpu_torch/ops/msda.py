"""Multi-scale deformable attention (MSDA): plain PyTorch version + dispatch.

Counterpart of ``memotr_tpu/ops/msda.py``.  Semantics are those of
``F.grid_sample(mode="bilinear", padding_mode="zeros",
align_corners=False)``: a location ``loc`` in [0, 1] samples pixel
coordinate ``loc * size - 0.5``, and each of the four bilinear corners
contributes zero on its own when it falls outside the map.

Layouts (as in the JAX package):
  value               (B, sum(H_l*W_l), M, D)
  spatial_shapes      ((H_0, W_0), ...) python ints
  sampling_locations  (B, Lq, M, L, P, 2) as (x, y)
  attention_weights   (B, Lq, M, L, P)
  returns             (B, Lq, M*D) in the value dtype

``ms_deform_attn`` dispatches by device: CPU tensors take the plain
version (whose gradient is autograd's), CUDA tensors the hand-written
kernels (``ops/msda_cuda.py``: the forward kernel, and under autograd the
backward kernel for the gradient).  Without a gradient the call is the
torch op ``msda_fwd`` (``ops/library.py``), which a traced or exported
graph carries as one node.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

Shapes = Sequence[Tuple[int, int]]


def _level_sample(value_l: torch.Tensor, loc: torch.Tensor, h: int,
                  w: int) -> torch.Tensor:
    """value_l (B, H*W, M, D); loc (B, Lq, M, P, 2) -> (B, Lq, M, P, D).

    The corner lerp runs in the value dtype, as the JAX version does
    (``memotr_tpu/ops/msda.py:80-84``)."""
    b, hw, m, d = value_l.shape
    px = loc[..., 0] * w - 0.5
    py = loc[..., 1] * h - 0.5
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = px - x0
    fy = py - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    xs = torch.stack([x0i, x0i + 1, x0i, x0i + 1], dim=-1)   # (B,Lq,M,P,4)
    ys = torch.stack([y0i, y0i, y0i + 1, y0i + 1], dim=-1)
    wts = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy),
                       (1 - fx) * fy, fx * fy], dim=-1)
    valid = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    rows = ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)
    # one flat (batch, head, token) gather table
    table = value_l.permute(0, 2, 1, 3).reshape(b * m * hw, d)
    bidx = torch.arange(b, device=rows.device).view(b, 1, 1, 1, 1)
    midx = torch.arange(m, device=rows.device).view(1, 1, m, 1, 1)
    gidx = ((bidx * m + midx) * hw + rows).reshape(-1)
    g = table.index_select(0, gidx).view(*rows.shape, d)      # (...,4,D)
    wts = torch.where(valid, wts, torch.zeros_like(wts)).to(g.dtype)
    return torch.einsum("blmpcd,blmpc->blmpd", g, wts)


def ms_deform_attn_torch(value: torch.Tensor, spatial_shapes: Shapes,
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch MSDA; the numerics reference of the CUDA kernel."""
    b, _, m, d = value.shape
    _, lq, _, nl, _, _ = sampling_locations.shape
    assert nl == len(spatial_shapes)
    out = value.new_zeros((b, lq, m, d))
    start = 0
    for lid, (h, w) in enumerate(spatial_shapes):
        value_l = value[:, start:start + h * w]
        start += h * w
        samples = _level_sample(value_l, sampling_locations[:, :, :, lid],
                                h, w)
        aw = attention_weights[:, :, :, lid].to(samples.dtype)
        out = out + torch.einsum("blmpd,blmp->blmd", samples, aw)
    return out.reshape(b, lq, m * d)


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Shapes,
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """With a gradient asked for: CPU tensors -> the plain version (whose
    gradient is autograd's), CUDA tensors -> ``MSDeformAttnFunction`` (the
    forward and backward kernels).  Otherwise the ``msda_fwd`` op
    (``ops/library.py``), which runs the forward kernel on CUDA tensors and
    the plain version on CPU tensors.  The kernels raise on what they do
    not take; there is no silent fallback."""
    loc, aw = sampling_locations, attention_weights
    if torch.is_grad_enabled() and (value.requires_grad or loc.requires_grad
                                    or aw.requires_grad):
        if value.is_cuda:
            from .msda_cuda import MSDeformAttnFunction
            return MSDeformAttnFunction.apply(
                value, loc, aw, tuple(map(tuple, spatial_shapes)))
        return ms_deform_attn_torch(value, spatial_shapes, loc, aw)
    from .library import flat_shapes, msda_fwd
    return msda_fwd(value, flat_shapes(spatial_shapes), loc, aw)
