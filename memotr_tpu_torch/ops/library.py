"""K1 and K2 forward as torch operators (``torch.ops.memotr_tpu_torch``).

Registered with ``torch.library.custom_op``, so that torch's tracers
(``torch.export``, ``torch.compile``) carry each kernel as one op node in
place of its ``ctypes`` launch, which they cannot look into:

- ``msda_fwd(value, spatial_shapes, loc, aw)``: K1, multi-scale deformable
  attention (``ops/msda.py`` has the layouts); ``spatial_shapes`` is the
  levels' ``(H, W)`` pairs flattened to ``[H_0, W_0, H_1, W_1, ...]``;
- ``window_attn_fwd(x, pos, mask, in_proj_weight, in_proj_bias,
  out_weight, out_bias, bias, n_heads, window_h, window_w)``: K2, fused
  window attention (``ops/window_attn.py``).

Each has an implementation for two devices, chosen by the dispatcher from
the inputs' device: on ``cuda`` the launch of the hand-written kernel
(``msda_cuda.msda_forward``, ``window_attn_cuda.window_attention_fwd``),
whose checks, shape-table cache and launch counter run only there, on real
tensors; on ``cpu`` the plain version.  Any other device raises.  The fake
implementation gives the output's shape and dtype from the inputs' and
reads no data, so a traced graph holds the same op node on both devices.

The ops have no autograd formula: the training route goes through
``MSDeformAttnFunction`` and ``WindowAttnFunction``.  Importing this module
registers the ops; ``torch.export.load`` of a program that holds them needs
it imported first.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .msda import ms_deform_attn_torch
from .window_attn import window_attention_torch

NAMESPACE = "memotr_tpu_torch"


def flat_shapes(spatial_shapes: Sequence[Tuple[int, int]]) -> List[int]:
    """((H_0, W_0), ...) -> [H_0, W_0, ...], the ops' schema."""
    return [int(v) for hw in spatial_shapes for v in hw]


def _pairs(flat: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(flat[i]), int(flat[i + 1]))
                 for i in range(0, len(flat), 2))


@torch.library.custom_op(f"{NAMESPACE}::msda_fwd", mutates_args=(),
                         device_types="cpu")
def msda_fwd(value: torch.Tensor, spatial_shapes: List[int],
             loc: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
    """K1 forward -> (B, Lq, M*D) in the value dtype."""
    return ms_deform_attn_torch(value, _pairs(spatial_shapes), loc, aw)


@msda_fwd.register_kernel("cuda")
def _msda_fwd_cuda(value, spatial_shapes, loc, aw):
    from .msda_cuda import msda_forward
    return msda_forward(value, _pairs(spatial_shapes), loc, aw)


@msda_fwd.register_fake
def _msda_fwd_fake(value, spatial_shapes, loc, aw):
    b, _, m, d = value.shape
    return value.new_empty((b, loc.shape[1], m * d))


@torch.library.custom_op(f"{NAMESPACE}::window_attn_fwd", mutates_args=(),
                         device_types="cpu")
def window_attn_fwd(x: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor,
                    in_proj_weight: torch.Tensor, in_proj_bias: torch.Tensor,
                    out_weight: torch.Tensor, out_bias: torch.Tensor,
                    bias: Optional[torch.Tensor], n_heads: int,
                    window_h: int, window_w: int) -> torch.Tensor:
    """K2 forward -> (B, H, W, C) in x's dtype."""
    return window_attention_torch(x, pos, mask, in_proj_weight, in_proj_bias,
                                  out_weight, out_bias, bias, n_heads,
                                  window_h, window_w)


@window_attn_fwd.register_kernel("cuda")
def _window_attn_fwd_cuda(x, pos, mask, in_proj_weight, in_proj_bias,
                          out_weight, out_bias, bias, n_heads, window_h,
                          window_w):
    from .window_attn_cuda import window_attention_fwd
    return window_attention_fwd(x, pos, mask, in_proj_weight, in_proj_bias,
                                out_weight, out_bias, bias, n_heads,
                                window_h, window_w)[0]


@window_attn_fwd.register_fake
def _window_attn_fwd_fake(x, pos, mask, in_proj_weight, in_proj_bias,
                          out_weight, out_bias, bias, n_heads, window_h,
                          window_w):
    return torch.empty_like(x)
