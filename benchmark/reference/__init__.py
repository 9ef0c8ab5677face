"""The benchmark's plain reference of MeMOTR: a frozen float32 copy of what
the cells run, and no more: the model (ResNet-50, input projections, the
configuration's encoder, the DAB decoder, the query updater) and the
streaming frame step (runtime tracker, query updater), in plain PyTorch
and no kernel.

The encoder is a part found by file: ``models/encoders/<ENCODER_TYPE>.py``
with ``build(config, dtype)``.  ``deformable.py`` is the deformable encoder
(``models/encoder.py``, deformable attention through ``ops/msda.py``);
``windowed.py`` the windowed one (window and grid attention through
``ops/window_attn.py``).  A configuration with another encoder brings its
part as a new file, and a model without one is refused with the name of
the file to add; what else a cell runs (training) brings its part the
same way.

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
