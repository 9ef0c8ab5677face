"""The port's plain window attention (K2's numerics reference) against the
JAX package, float32, CPU.

Cases of tests/test_window_attn.py: B=2, a 16x24 map, C=32, 4 heads,
window 4, padding in the last columns and one fully padded window, bias on
and off, and grid attention through ``grid_transpose``.  The port is held
against ``window_attention_xla`` and against the Pallas kernel in interpret
mode at atol/rtol 1e-5 (float32 sums in another order); the grid transpose
round trip and its agreement with JAX are exact.  The bfloat16 case is a
smoke test at 0.1 (the two frameworks round at other places).  The port's
weights are ``nn.MultiheadAttention``'s: ``in_proj_weight`` is the three
JAX kernels transposed and stacked.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memotr_tpu.ops import window_attn as jwa
from memotr_tpu_torch.ops import window_attn as twa

B, H, W, C, HEADS, WIN = 2, 16, 24, 32, 4, 4
TOL = dict(rtol=1e-5, atol=1e-5)


def make_inputs(seed=0, dead_window=True, grid=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    pos = (rng.randn(B, H, W, C) * 0.5).astype(np.float32)
    mask = np.zeros((B, H, W), bool)
    mask[:, :, W - 3:] = True
    if dead_window:
        mask[1, :WIN, :WIN] = True
    p = {}
    for name in ("q", "k", "v", "o"):
        p["w" + name] = (rng.randn(C, C) / np.sqrt(C)).astype(np.float32)
        p["b" + name] = (rng.randn(C) * 0.1).astype(np.float32)
    l = (H // WIN) * (W // WIN) if grid else WIN * WIN
    bias = (rng.randn(HEADS, l, l) * 0.3).astype(np.float32)
    return x, pos, mask, p, bias


def jax_args(x, pos, mask, p, bias):
    return tuple(jnp.asarray(a) for a in (x, pos, mask)) + tuple(
        jnp.asarray(p[k]) for k in ("wq", "bq", "wk", "bk", "wv", "bv",
                                    "wo", "bo")) + (
        None if bias is None else jnp.asarray(bias),)


def port_args(x, pos, mask, p, bias):
    t = torch.from_numpy
    in_w = np.concatenate([p["wq"].T, p["wk"].T, p["wv"].T])
    in_b = np.concatenate([p["bq"], p["bk"], p["bv"]])
    return (t(x), t(pos), t(mask), t(in_w), t(in_b),
            t(np.ascontiguousarray(p["wo"].T)), t(p["bo"]),
            None if bias is None else t(bias))


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dead_window", [True, False])
def test_plain_matches_xla(with_bias, dead_window):
    x, pos, mask, p, bias = make_inputs(dead_window=dead_window)
    bias = bias if with_bias else None
    want = jwa.window_attention_xla(*jax_args(x, pos, mask, p, bias), HEADS,
                                    WIN, WIN)
    got = twa.window_attention_torch(*port_args(x, pos, mask, p, bias),
                                     HEADS, WIN, WIN)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_matches_pallas_interpret(with_bias):
    x, pos, mask, p, bias = make_inputs(seed=2)
    bias = bias if with_bias else None
    want = jwa.window_attention_pallas(*jax_args(x, pos, mask, p, bias),
                                       HEADS, WIN, WIN, True)
    got = twa.window_attention_torch(*port_args(x, pos, mask, p, bias),
                                     HEADS, WIN, WIN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_grid_mode_matches_pallas_interpret():
    """Grid attention: the block-transposed map through the kernel's
    contract, untransposed, on both sides."""
    x, pos, mask, p, bias = make_inputs(seed=1, grid=True)
    nbh, nbw = H // WIN, W // WIN
    jt = [jwa.grid_transpose(jnp.asarray(a), WIN) for a in (x, pos, mask)]
    want = jwa.grid_untranspose(jwa.window_attention_pallas(
        *jt, *jax_args(x, pos, mask, p, bias)[3:], HEADS, nbh, nbw, True),
        WIN)
    args = port_args(x, pos, mask, p, bias)
    tt = [twa.grid_transpose(a, WIN) for a in args[:3]]
    got = twa.grid_untranspose(twa.window_attention(
        *tt, *args[3:], HEADS, nbh, nbw), WIN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(B, H, W, C), (B, H, W), (1, 8, 12, 3)])
def test_grid_transpose_round_trip_is_exact(shape):
    a = np.random.RandomState(3).randn(*shape).astype(np.float32)
    t = twa.grid_transpose(torch.from_numpy(a), WIN)
    np.testing.assert_array_equal(t.numpy(), np.asarray(
        jwa.grid_transpose(jnp.asarray(a), WIN)))
    np.testing.assert_array_equal(twa.grid_untranspose(t, WIN).numpy(), a)


def test_dispatch_takes_plain_version_on_cpu():
    x, pos, mask, p, bias = make_inputs(seed=4)
    args = port_args(x, pos, mask, p, bias)
    torch.testing.assert_close(
        twa.window_attention(*args, HEADS, WIN, WIN),
        twa.window_attention_torch(*args, HEADS, WIN, WIN), rtol=0, atol=0)


def test_bf16_smoke():
    x, pos, mask, p, bias = make_inputs(seed=4)
    jargs = jax_args(x, pos, mask, p, bias)
    jb = tuple(a.astype(jnp.bfloat16) if i in (0, 1) or 3 <= i <= 10 else a
               for i, a in enumerate(jargs))
    want = jwa.window_attention_xla(*jb, HEADS, WIN, WIN)
    args = port_args(x, pos, mask, p, bias)
    got = twa.window_attention_torch(args[0].bfloat16(), args[1].bfloat16(),
                                     *args[2:], HEADS, WIN, WIN)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0.1,
                               atol=0.1)
