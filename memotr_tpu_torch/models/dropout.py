"""Seeded dropout and per-layer gradient checkpointing (counterparts of
flax's ``nn.Dropout`` and ``nn.remat`` in the JAX package's models).

**Dropout.**  A ``Dropout`` module is one site of the model.  Its mask is a
function of a seed and the site alone: ``draw_keep_mask`` draws it from a
generator seeded with ``mix_seed(seed, site, call)``, where ``seed`` is the
one the training step sets around a frame's forward (``dropout_seed``),
``site`` the module's number in the model (``number_sites``) and ``call``
the caller's index of a site it runs more than once a forward (the
windowed layer's levels).  That is what flax's key folding gives JAX: a
frame's key, folded with the module path and a call counter.  Dropout is
active only in training mode, with ``p > 0``, inside ``dropout_seed``: the
streaming, evaluation and serving paths, and a distillation teacher (in
eval mode), never drop.  Kept values are scaled by ``1 / (1 - p)``, as
flax's ``lax.select(mask, x / keep, 0)``.

**Checkpointing.**  ``run_layer`` runs one layer under
``torch.utils.checkpoint`` (non-reentrant) when gradients are being
taken: the layer's activations are dropped after the forward and
recomputed in the backward.  The recompute runs inside the seed of the
forward, so it draws the same masks; ``preserve_rng_state`` would restore
only the global generators, never a seeded one.  Where no gradient is
taken (``no_grad`` frames, streaming) the layer runs as it is.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

_SEED: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "dropout_seed", default=None)
_MASK64 = (1 << 64) - 1


def mix_seed(*parts: int) -> int:
    """A 63-bit seed from integers (splitmix64 over each part in turn), so
    that nearby inputs give unrelated seeds."""
    z = 0x9E3779B97F4A7C15
    for p in parts:
        z = (z ^ (int(p) & _MASK64)) * 0xBF58476D1CE4E5B9 & _MASK64
        z = (z ^ (z >> 31)) * 0x94D049BB133111EB & _MASK64
        z ^= z >> 29
    return z >> 1


@contextlib.contextmanager
def dropout_seed(seed: Optional[int]) -> Iterator[None]:
    """Dropout inside this block draws from ``seed`` (None: no dropout)."""
    token = _SEED.set(seed)
    try:
        yield
    finally:
        _SEED.reset(token)


def draw_keep_mask(shape, keep: float, seed: int,
                   device: torch.device) -> torch.Tensor:
    """The one mask draw: a bool tensor, True with probability ``keep``,
    from a generator seeded with ``seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=g, device=device) < keep


class Dropout(nn.Module):
    """One dropout site; ``site`` is set by ``number_sites``."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)
        self.site = 0

    def active(self) -> bool:
        return self.training and self.p > 0.0 and _SEED.get() is not None

    def forward(self, x: torch.Tensor, call: int = 0) -> torch.Tensor:
        if not self.active():
            return x
        keep = 1.0 - self.p
        mask = draw_keep_mask(x.shape, keep,
                              mix_seed(_SEED.get(), self.site, call),
                              x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x))


def number_sites(model: nn.Module) -> None:
    """Numbers every ``Dropout`` of ``model`` in module order."""
    sites = [m for m in model.modules() if isinstance(m, Dropout)]
    for n, mod in enumerate(sites):
        mod.site = n


def run_layer(layer: nn.Module, *args, use_checkpoint: bool = False):
    """``layer(*args)``, checkpointed when ``use_checkpoint`` holds and a
    gradient is being taken."""
    if not (use_checkpoint and torch.is_grad_enabled()):
        return layer(*args)
    seed = _SEED.get()

    def fn(*a):
        with dropout_seed(seed):
            return layer(*a)
    return checkpoint(fn, *args, use_reentrant=False)
