"""Gradients of the port's plain MSDA against the JAX package (CPU).

Autograd of ``ms_deform_attn_torch`` against ``jax.vjp`` of
``ms_deform_attn_xla`` on the cases of tests/test_msda.py (out-of-bounds
taps, B=2, odd channel widths) and against the VJP of
``ms_deform_attn_pallas(interpret=True)`` (whose backward is the XLA
version's VJP) on its tiling shapes; a float64 ``gradcheck`` of the plain
version itself.  Float32 tolerance: atol 1e-5 on grad_value and grad_aw
(sums of a few products), atol 1e-4 on grad_loc (scaled by the level's
width, up to 17 here).  The CUDA backward kernel is held against this
plain version on the card (tests/test_torch_msda_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memotr_tpu.ops.msda import ms_deform_attn_xla
from memotr_tpu.ops.msda_pallas import ms_deform_attn_pallas
from memotr_tpu_torch.ops.msda import ms_deform_attn, ms_deform_attn_torch
from test_torch_msda import PALLAS_CASES, XLA_CASES, _inputs


def _port_grads(value, shapes, loc, w, g):
    v, l, a = (torch.from_numpy(x).requires_grad_() for x in (value, loc, w))
    out = ms_deform_attn(v, shapes, l, a)
    out.backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in (v, l, a)]


def _cotangent(seed, value, loc):
    b, lq, m = loc.shape[:3]
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, lq, m * value.shape[3])).astype(np.float32)


def _assert_grads(got, want):
    for name, g, w, atol in zip(("value", "loc", "aw"), got, want,
                                (1e-5, 1e-4, 1e-5)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(XLA_CASES))
def test_plain_grads_match_xla_vjp(case):
    value, shapes, loc, w = _inputs(0, **XLA_CASES[case])
    g = _cotangent(1, value, loc)
    _, vjp = jax.vjp(lambda v, l, a: ms_deform_attn_xla(v, shapes, l, a),
                     jnp.asarray(value), jnp.asarray(loc), jnp.asarray(w))
    _assert_grads(_port_grads(value, shapes, loc, w, g), vjp(jnp.asarray(g)))


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_plain_grads_match_pallas_interpret_vjp(case):
    value, shapes, loc, w = _inputs(1, lo=-0.15, hi=1.15,
                                    **PALLAS_CASES[case])
    g = _cotangent(2, value, loc)
    _, vjp = jax.vjp(
        lambda v, l, a: ms_deform_attn_pallas(v, shapes, l, a, True),
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(w))
    _assert_grads(_port_grads(value, shapes, loc, w, g), vjp(jnp.asarray(g)))


def test_plain_version_gradcheck_float64():
    """The plain backward is itself right: finite differences in float64
    (taps kept off the pixel grid's integer crossings, where the bilinear
    derivative jumps)."""
    value, shapes, loc, w = _inputs(3, b=1, m=2, d=3, lq=3, p=2,
                                    shapes=((4, 5), (2, 3)))
    args = [torch.from_numpy(x).double().requires_grad_()
            for x in (value, loc, w)]
    assert torch.autograd.gradcheck(
        lambda v, l, a: ms_deform_attn_torch(v, shapes, l, a), args,
        eps=1e-6, atol=1e-5)
