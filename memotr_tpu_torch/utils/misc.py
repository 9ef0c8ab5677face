"""Small numeric and set-up helpers (counterpart of
``memotr_tpu/utils/misc.py``)."""
from __future__ import annotations

import math
import os
import random

import numpy as np
import torch


def host_to_device(array, device: torch.device | str,
                   dtype: torch.dtype | None = None) -> torch.Tensor:
    """A host array (numpy, list or CPU tensor) on ``device`` without a
    host sync: on CUDA it is copied into pinned memory and uploaded
    ``non_blocking`` on the current stream (a pageable copy would wait for
    the stream to drain); elsewhere a plain copy.  Under a tracer
    (``torch.export``) the array is made on ``device`` directly, so that
    the graph holds it as a device constant and copies nothing a call."""
    if torch.compiler.is_compiling():
        return torch.as_tensor(array, dtype=dtype, device=device)
    t = torch.as_tensor(array, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


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


def set_seed(seed: int, rank: int = 0) -> int:
    """Seeds the host generators the data pipeline draws from (``random``,
    ``np.random``, ``PYTHONHASHSEED``) with ``seed + rank``, as the JAX
    package does, so that both draw the same augmentations.  Returns the
    seed used."""
    seed = seed + rank
    np.random.seed(seed)
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed
