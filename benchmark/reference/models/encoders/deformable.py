"""``ENCODER_TYPE: deformable``: the deformable encoder
(``models/encoder.py``) as it stands, deformable attention through
``ops/msda.py``."""
from __future__ import annotations

import torch

from ..encoder import Encoder


def build(config: dict, dtype: torch.dtype) -> Encoder:
    return Encoder(config["NUM_ENC_LAYERS"], config["HIDDEN_DIM"],
                   config["FFN_DIM"], config["NUM_FEATURE_LEVELS"],
                   config["NUM_HEADS"], config["NUM_ENC_POINTS"], dtype=dtype)
