"""The benchmark's plain reference of MeMOTR: a frozen float32 copy of what
the cells run, and no more: the model (ResNet-50, input projections, the
deformable encoder, the DAB decoder, the query updater) and the streaming
frame step (runtime tracker, query updater), with deformable attention in
plain PyTorch (``ops/msda.py``) and no kernel.  A cell that runs more (the
windowed encoder, training) brings its part of the reference with it.

It imports nothing of the program under test.  ``build(config)`` gives the
model in float32 whatever the configuration's ``DTYPE``; callers turn TF32
off (``no_tf32``) before running it on a card.
"""
from __future__ import annotations

import contextlib

import torch

from .models.memotr import build_model


def build(config: dict) -> torch.nn.Module:
    """The configuration's model, computing in float32."""
    return build_model(dict(config, DTYPE="float32"))


@contextlib.contextmanager
def no_tf32():
    """Float32 matrix products and convolutions in float32, not TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
