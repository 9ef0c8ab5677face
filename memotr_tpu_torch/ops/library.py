"""K1 and K2 forward and the convolution tail as torch operators
(``torch.ops.memotr_tpu_torch``).

Registered with ``torch.library`` (``custom_op``; ``conv_tail``, which runs
most often, on the low-level ``Library``), so that torch's tracers
(``torch.export``, ``torch.compile``) carry each kernel as one op node in
place of its ``ctypes`` launch, which they cannot look into:

- ``msda_fwd(value, spatial_shapes, loc, aw)``: K1, multi-scale deformable
  attention (``ops/msda.py`` has the layouts); ``spatial_shapes`` is the
  levels' ``(H, W)`` pairs flattened to ``[H_0, W_0, H_1, W_1, ...]``;
- ``window_attn_fwd(x, pos, mask, in_proj_weight, in_proj_bias,
  out_weight, out_bias, bias, n_heads, window_h, window_w)``: K2, fused
  window attention (``ops/window_attn.py``);
- ``conv_tail(y, bias, identity, relu)``: ``y <- act(y + bias[c] (+
  identity))`` in place, the end of each of the backbone's folded
  convolutions on its inference route (``ops/conv_tail.py``).

Each has an implementation for two devices, chosen by the dispatcher from
the inputs' device: on ``cuda`` the launch of the hand-written kernel
(``msda_cuda.msda_forward``, ``window_attn_cuda.window_attention_fwd``,
``conv_tail.conv_tail_cuda``), whose checks, shape-table cache and launch counter run only there, on real
tensors; on ``cpu`` the plain version.  Any other device raises.  The fake
implementation gives the output's shape and dtype from the inputs' and
reads no data, so a traced graph holds the same op node on both devices
(``conv_tail`` returns nothing: its result is the mutated ``y``).

The ops have no autograd formula: the training route goes through
``MSDeformAttnFunction``, ``WindowAttnFunction`` and the backbone's
unfolded convolutions.  Importing this module
registers the ops; ``torch.export.load`` of a program that holds them needs
it imported first.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .conv_tail import conv_tail_torch
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
                                window_h, window_w, head_outputs=False)[0]


@window_attn_fwd.register_fake
def _window_attn_fwd_fake(x, pos, mask, in_proj_weight, in_proj_bias,
                          out_weight, out_bias, bias, n_heads, window_h,
                          window_w):
    return torch.empty_like(x)


# conv_tail runs 49 times a backbone call, so it is defined with the
# low-level ``torch.library.Library``: a call costs a few microseconds of
# host time, against some 25 for a ``custom_op``, whose Python wrapper
# checks aliasing and versions on every call.
_lib = torch.library.Library(NAMESPACE, "FRAGMENT")
_lib.define("conv_tail(Tensor(a!) y, Tensor bias, Tensor? identity, "
            "bool relu) -> ()")


def _conv_tail_cpu(y, bias, identity, relu):
    y.copy_(conv_tail_torch(y, bias, identity, relu))


def _conv_tail_cuda(y, bias, identity, relu):
    from .conv_tail import conv_tail_cuda
    conv_tail_cuda(y, bias, identity, relu)


_lib.impl("conv_tail", _conv_tail_cpu, "CPU")
_lib.impl("conv_tail", _conv_tail_cuda, "CUDA")


@torch.library.register_fake(f"{NAMESPACE}::conv_tail", lib=_lib)
def _conv_tail_fake(y, bias, identity, relu):
    return None


conv_tail = torch.ops.memotr_tpu_torch.conv_tail.default
