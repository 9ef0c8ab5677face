"""The convolution tail: ``y <- act(y + bias[c] (+ identity))``, in place.

What is left of a ``conv -> frozen BatchNorm -> (+ identity) -> ReLU`` once
the BatchNorm is folded into the convolution (``models/resnet.py: fold``).
``y`` and ``identity`` are (N, C, H, W) maps, ``bias`` float32 (C,); the sum
is taken in float32, bias first, and rounded once to ``y``'s dtype.

- ``conv_tail_torch``: the plain version (returns the result);
- ``conv_tail_cuda``: the hand-written kernel ``csrc/conv_tail.cu`` (its
  header says what bounds it and how it is built), compiled with ``nvcc`` at
  first use and loaded with ``ctypes`` (``ops/_build.py``).  It takes
  channels_last float32 or bfloat16 maps only and raises on anything else.

The model reaches both through the ``conv_tail`` op (``ops/library.py``),
which picks by the inputs' device.  ``launches`` counts launches of the
kernel (and nothing else), so a run can show that its backbone went
through it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NAME = "conv_tail"

launches = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# y, identity, bias; dtype, 16-byte vectors, vectors a row, relu; stream
_ARGTYPES = {"conv_tail": [ctypes.c_void_p] * 3
             + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]}
MAX_ROW_VECTORS = 1024      # a block holds at least one row of C channels


def conv_tail_torch(y: torch.Tensor, bias: torch.Tensor,
                    identity: Optional[torch.Tensor],
                    relu: bool) -> torch.Tensor:
    """act(y + bias[c] (+ identity)) in float32, rounded once to y's dtype."""
    s = y.float() + bias.float().view(1, -1, 1, 1)
    if identity is not None:
        s = s + identity.float()
    if relu:
        s = torch.relu(s)
    return s.to(y.dtype)


def _check(y: torch.Tensor, bias: torch.Tensor,
           identity: Optional[torch.Tensor]) -> None:
    """Raise on what the kernel does not take (device, dtype, shape,
    layout, alignment)."""
    if not y.is_cuda:
        raise ValueError(f"y must be on a CUDA device, got {y.device}")
    if y.dtype not in _DTYPES:
        raise TypeError(f"y dtype {y.dtype} not supported (float32 or "
                        "bfloat16)")
    if y.dim() != 4 or not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("y must be a channels_last-contiguous (N, C, H, W) "
                         f"map, got shape {tuple(y.shape)} strides "
                         f"{y.stride()}")
    c = y.shape[1]
    if (c * y.element_size()) % 16 or c * y.element_size() // 16 > \
            MAX_ROW_VECTORS:
        raise ValueError(f"{c} channels of {y.dtype}: a row must be a "
                         f"multiple of 16 bytes, at most {16 * MAX_ROW_VECTORS}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (c,) or \
            not bias.is_contiguous() or bias.device != y.device:
        raise ValueError(f"bias must be float32 ({c},) contiguous on "
                         f"{y.device}, got {bias.dtype} {tuple(bias.shape)} "
                         f"on {bias.device}")
    if identity is not None:
        if identity.shape != y.shape or identity.dtype != y.dtype or \
                identity.device != y.device or \
                not identity.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("identity must be a channels_last "
                             f"{tuple(y.shape)} {y.dtype} map on {y.device}")
        if identity.data_ptr() == y.data_ptr():
            raise ValueError("identity must not be y itself")
    for name, t in (("y", y), ("bias", bias), ("identity", identity)):
        if t is not None and t.data_ptr() % 16:       # 16-byte loads
            raise ValueError(f"{name} must be 16-byte aligned")


def conv_tail_cuda(y: torch.Tensor, bias: torch.Tensor,
                   identity: Optional[torch.Tensor], relu: bool) -> None:
    """Launch the kernel on checked inputs: y is overwritten."""
    global launches
    _check(y, bias, identity)
    n = y.numel() * y.element_size() // 16
    if n == 0:
        return
    lib = _build.load(NAME, _ARGTYPES)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    rc = lib.conv_tail(y.data_ptr(),
                       None if identity is None else identity.data_ptr(),
                       bias.data_ptr(), _DTYPES[y.dtype], n,
                       y.shape[1] * y.element_size() // 16, int(relu), stream)
    if rc != 0:
        raise RuntimeError(f"conv_tail launch failed: CUDA error {rc}")
    launches += 1
