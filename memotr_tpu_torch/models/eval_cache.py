"""Sequence constants of the streaming step, computed once per padding mask
(counterpart of ``memotr_tpu/models/eval_cache.py``).

Two things in a frame step depend on the frame's padding mask and the
parameters only, not on the pixels:

- the sine position maps of the four pyramid levels;
- the windowed encoder's continuous-position-bias tables, per layer and
  level (an MLP over a static offset table).

``EvalCache`` computes the position maps on the host in numpy, as the JAX
package's cache does (the same float32 steps, so the two caches hold the
same maps), and the bias tables on the model's device with the port's own
CPB modules; it keeps both while the padding mask stays the same.  Unlike
the JAX package, which snapshots frame 0's mask for the whole sequence, it
compares every frame's mask with the cached one on the host and rebuilds
when it differs.

The cached maps equal the per-frame ones (``sine_position_embedding``) on
the valid region to float32 rounding.  On a padded row or column whose
every pixel is padding the normalised coordinate is (0 - 0.5) / 1e-6 * 2pi
(the reference's eps division), where a 1-ulp difference in a frequency
moves the sine far; those values differ between any two implementations,
as they do between the JAX package's cached and uncached paths.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.misc import host_to_device
from ..utils.profiling import span
from .windowed_encoder import WindowedEncoder


def pyramid_shapes(h: int, w: int, n_levels: int = 4
                   ) -> Tuple[Tuple[int, int], ...]:
    """Level shapes of an (h, w) input: each halves with ceil rounding
    (stride-2 convs with padding), level l is ceil(x / 2**(3 + l))."""
    return tuple((math.ceil(h / 2 ** (3 + i)), math.ceil(w / 2 ** (3 + i)))
                 for i in range(n_levels))


def np_downsample_mask(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    """Floor-index nearest downsample of a (B, H, W) mask (as
    ``memotr._downsample_mask``)."""
    _, hh, ww = mask.shape
    return mask[:, (np.arange(h) * hh) // h][:, :, (np.arange(w) * ww) // w]


def np_sine_position_embedding(mask: np.ndarray, num_pos_feats: int,
                               temperature: float = 20.0,
                               scale: float = 2 * np.pi) -> np.ndarray:
    """numpy float32 sine position embedding, (B, H, W, 2F), the steps of
    the JAX package's host mirror (``eval_cache.py:66``)."""
    not_mask = (~mask).astype(np.float32)
    y = np.cumsum(not_mask, axis=1, dtype=np.float32)
    x = np.cumsum(not_mask, axis=2, dtype=np.float32)
    eps = 1e-6
    y = (y - 0.5) / (y[:, -1:, :] + eps) * scale
    x = (x - 0.5) / (x[:, :, -1:] + eps) * scale
    dim_i = np.arange(num_pos_feats, dtype=np.float32)
    dim_i = (temperature ** (2.0 * np.floor(dim_i / 2.0)
                             / num_pos_feats)).astype(np.float32)
    pos_x = x[..., None] / dim_i
    pos_y = y[..., None] / dim_i
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])],
                     axis=-1).reshape(*x.shape, -1)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])],
                     axis=-1).reshape(*y.shape, -1)
    return np.concatenate([pos_y, pos_x], axis=-1).astype(np.float32)


def same_mask(a: np.ndarray, b: np.ndarray) -> bool:
    """Whether two bool masks of one shape hold the same bytes, compared
    eight at a time where the size allows (a 24-lane canvas mask is 29.5
    MB and is compared every step; ``np.array_equal`` on the bools took
    ~12.6 ms of the dispatch thread).  Masks whose bytes differ where their
    values agree cost a rebuild, not a wrong answer."""
    if a.nbytes % 8 or not (a.flags.c_contiguous and b.flags.c_contiguous):
        return np.array_equal(a, b)
    return np.array_equal(a.reshape(-1).view(np.uint64),
                          b.reshape(-1).view(np.uint64))


class EvalCache:
    """Per-sequence constants for ``MeMOTR.forward(..., eval_ctx=...)``.

    ``lookup(mask)`` takes the frame's (B, H, W) numpy padding mask and
    returns the constants for it, rebuilt only when the mask differs from
    the last one (``builds`` counts the rebuilds)."""

    def __init__(self, model, device: torch.device | str):
        self.model = model
        self.device = torch.device(device)
        self.builds = 0
        self._mask: Optional[np.ndarray] = None
        self._ctx: Optional[Dict] = None

    def lookup(self, img_mask: np.ndarray) -> Dict:
        img_mask = np.asarray(img_mask, bool)
        if self._mask is None or self._mask.shape != img_mask.shape or \
                not same_mask(self._mask, img_mask):
            with span("step.eval_cache_build"):
                self._ctx = self._build(img_mask)
            self._mask = img_mask.copy()
            self.builds += 1
        return self._ctx

    @torch.inference_mode()
    def _build(self, img_mask: np.ndarray) -> Dict:
        m = self.model
        shapes = pyramid_shapes(img_mask.shape[1], img_mask.shape[2],
                                m.n_feature_levels)
        poss = [host_to_device(np_sine_position_embedding(
                    np_downsample_mask(img_mask, h, w), m.hidden_dim // 2),
                    self.device) for h, w in shapes]
        enc = m.transformer.encoder
        tables = enc.bias_tables(shapes) \
            if isinstance(enc, WindowedEncoder) else None
        return {"pos_embeds": poss, "cpb_tables": tables}
