"""PyTorch-port MSDA against the JAX package (float32, CPU).

The port's plain version ``ms_deform_attn_torch`` is held against
``ms_deform_attn_xla`` on the cases of tests/test_msda.py (out-of-bounds
taps, B=2, odd channel widths), against the Pallas kernel in interpret mode
on its own tiling shapes, and against the grid_sample oracle.  Tolerance:
atol 1e-5, rtol 1e-4 (float32 sums in another order).  The CUDA kernel runs
only on a GPU: its tests are in tests/test_torch_msda_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memotr_tpu.ops.msda import ms_deform_attn_xla
from memotr_tpu.ops.msda_pallas import _Q_TILE, ms_deform_attn_pallas
from memotr_tpu_torch.ops import msda_cuda
from memotr_tpu_torch.ops.msda import ms_deform_attn, ms_deform_attn_torch
from test_msda import torch_oracle


def _inputs(seed, b=2, m=4, d=16, lq=10, p=3,
            shapes=((12, 17), (6, 9), (3, 5)), lo=-0.2, hi=1.2):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.normal(size=(b, s, m, d)).astype(np.float32)
    loc = rng.uniform(lo, hi, size=(b, lq, m, len(shapes), p, 2)
                      ).astype(np.float32)
    w = rng.uniform(size=(b, lq, m, len(shapes), p)).astype(np.float32)
    w = w / w.sum(axis=(-1, -2), keepdims=True)
    return value, shapes, loc, w


def _torch(value, shapes, loc, w):
    return ms_deform_attn_torch(torch.from_numpy(value), shapes,
                                torch.from_numpy(loc),
                                torch.from_numpy(w)).numpy()


XLA_CASES = {
    "oob_b2": dict(),
    "single_level_single_head": dict(b=1, m=1, d=8, lq=4, p=2,
                                     shapes=((7, 7),)),
    "d30": dict(b=1, m=2, d=30, lq=3, p=2, shapes=((5, 5), (3, 3))),
    "d32": dict(b=1, m=2, d=32, lq=3, p=2, shapes=((5, 5), (3, 3))),
    "d64": dict(b=1, m=2, d=64, lq=3, p=2, shapes=((5, 5), (3, 3))),
    "d71": dict(b=1, m=2, d=71, lq=3, p=2, shapes=((5, 5), (3, 3))),
    "decoder_like_b2": dict(b=2, m=8, d=4, lq=40, p=4,
                            shapes=((10, 19), (5, 10), (3, 5), (2, 3))),
}


@pytest.mark.parametrize("case", sorted(XLA_CASES))
def test_plain_matches_xla(case):
    value, shapes, loc, w = _inputs(0, **XLA_CASES[case])
    ref = np.asarray(ms_deform_attn_xla(jnp.asarray(value), shapes,
                                        jnp.asarray(loc), jnp.asarray(w)))
    np.testing.assert_allclose(_torch(value, shapes, loc, w), ref,
                               rtol=1e-4, atol=1e-5)


PALLAS_CASES = {
    "four_levels": dict(b=2, m=4, d=8, p=4, lq=37,
                        shapes=((25, 42), (13, 21), (7, 11), (4, 6))),
    "awkward": dict(b=1, m=2, d=16, p=3, lq=5, shapes=((11, 17),)),
    "query_tiling": dict(b=1, m=2, d=8, p=2, lq=_Q_TILE + 44,
                         shapes=((13, 21), (7, 11))),
}


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_plain_matches_pallas_interpret(case):
    value, shapes, loc, w = _inputs(1, lo=-0.15, hi=1.15,
                                    **PALLAS_CASES[case])
    ref = np.asarray(ms_deform_attn_pallas(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(w), True))
    np.testing.assert_allclose(_torch(value, shapes, loc, w), ref, atol=1e-5)


def test_plain_matches_grid_sample_oracle():
    value, shapes, loc, w = _inputs(2)
    np.testing.assert_allclose(_torch(value, shapes, loc, w),
                               torch_oracle(value, shapes, loc, w),
                               rtol=1e-4, atol=1e-5)


def test_out_of_bounds_taps_are_zero():
    value, shapes, loc, w = _inputs(3, b=1, m=2, d=4, lq=6, p=2)
    loc[..., 0] = 1.0 + 0.5 / 3        # a half pixel past the right edge
    np.testing.assert_array_equal(_torch(value, shapes, loc, w), 0.0)


def test_dispatch_takes_plain_version_on_cpu():
    value, shapes, loc, w = _inputs(4)
    before = msda_cuda.launches
    out = ms_deform_attn(torch.from_numpy(value), shapes,
                         torch.from_numpy(loc), torch.from_numpy(w))
    np.testing.assert_array_equal(out.numpy(), _torch(value, shapes, loc, w))
    assert msda_cuda.launches == before


def test_cuda_wrapper_rejects_cpu_tensors():
    value, shapes, loc, w = _inputs(5)
    with pytest.raises(ValueError, match="must be on"):
        msda_cuda.msda_forward(torch.from_numpy(value), shapes,
                               torch.from_numpy(loc), torch.from_numpy(w))
