"""Gradients of the port's plain window attention (K2's numerics reference)
against the JAX package (CPU).

Autograd of ``window_attention_torch`` against ``jax.vjp`` of
``window_attention_xla`` and of ``window_attention_pallas(interpret=True)``
(whose custom VJP is the XLA version's) on the cases of
tests/test_window_attn.py: window and grid-transposed maps, bias on and
off, padded keys and fully padded (opened) windows, groups of L = 6, 16,
24 (4 x 6, not square) and 84, B=2, and the Pallas forward with fewer
windows per program than the row holds (``wpp`` < ``n_win_w``).  The
cotangent is random everywhere, padded rows included.  Every gradient is
compared: x, pos, the joint ``in_proj_weight`` / ``in_proj_bias`` against
JAX's separate q/k/v kernels and biases, ``out_weight`` / ``out_bias`` and
the bias table.  Float32 tolerance: rtol 1e-4 and atol 1e-5 plus 2e-6 of
the leaf's largest element (sums over the group's keys and the map's
tokens in another order; the weight gradients sum some 800 products of
magnitude up to ~20 that cancel to ~1e-3 at a few elements).  A float64
``gradcheck`` holds the plain backward itself.  The CUDA backward kernel is
held against this plain version on the card
(tests/test_torch_window_attn_cuda.py, ``chip_smoke.py`` phase 14).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memotr_tpu.ops import window_attn as jwa
from memotr_tpu_torch.ops import window_attn as twa

RTOL, ATOL, ATOL_OF_MAX = 1e-4, 1e-5, 2e-6

# (B, H, W, C, heads, window, grid, bias, dead window): a grid case runs
# on the map block-transposed by ``window``, its groups (H/win, W/win)
CASES = {
    "window_l16": (2, 16, 24, 32, 4, 4, False, True, True),
    "window_l16_nobias": (2, 16, 24, 32, 4, 4, False, False, True),
    "window_l16_nodead": (2, 16, 24, 32, 4, 4, False, True, False),
    "grid_l24_4x6": (2, 16, 24, 32, 4, 4, True, True, True),
    "grid_l6_b2": (2, 4, 6, 16, 2, 2, True, True, False),
    "grid_l84": (1, 14, 24, 16, 2, 2, True, True, True),
}


def _inputs(seed, b, h, w, c, heads, win, grid, with_bias, dead):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    pos = (rng.randn(b, h, w, c) * 0.5).astype(np.float32)
    mask = np.zeros((b, h, w), bool)
    mask[:, :, w - 3:] = True
    if dead:
        mask[-1, :win, :win] = True
    p = {}
    for name in ("q", "k", "v", "o"):
        p["w" + name] = (rng.randn(c, c) / np.sqrt(c)).astype(np.float32)
        p["b" + name] = (rng.randn(c) * 0.1).astype(np.float32)
    wh, ww = (h // win, w // win) if grid else (win, win)
    bias = (rng.randn(heads, wh * ww, wh * ww) * 0.3).astype(np.float32) \
        if with_bias else None
    if grid:
        x, pos, mask = (np.asarray(jwa.grid_transpose(jnp.asarray(a), win))
                        for a in (x, pos, mask))
    g = rng.randn(*x.shape).astype(np.float32)
    return (x, pos, mask, p, bias, g), (heads, wh, ww)


def _jax_grads(fn, x, pos, mask, p, bias, g):
    """VJP of ``fn``, jitted (one compile a case, not one a primitive) ->
    the port's layout: (x, pos, in_w, in_b, out_w, out_b, bias)."""
    names = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
    diff = (jnp.asarray(x), jnp.asarray(pos)) + tuple(
        jnp.asarray(p[k]) for k in names) + (
        (jnp.asarray(bias),) if bias is not None else ())

    def f(*a):
        return fn(a[0], a[1], jnp.asarray(mask), *a[2:10],
                  a[10] if bias is not None else None)

    gr = [np.asarray(t) for t in jax.jit(
        lambda gg, *a: jax.vjp(f, *a)[1](gg))(jnp.asarray(g), *diff)]
    gx, gpos, (gwq, gbq, gwk, gbk, gwv, gbv, gwo, gbo) = gr[0], gr[1], gr[2:10]
    return [gx, gpos, np.concatenate([gwq.T, gwk.T, gwv.T]),
            np.concatenate([gbq, gbk, gbv]), gwo.T, gbo,
            gr[10] if bias is not None else None]


def _port_grads(x, pos, mask, p, bias, g, geo, dtype=torch.float32):
    t = lambda a: torch.from_numpy(np.array(a)).to(dtype)  # noqa: E731
    leaves = [t(x), t(pos),
              t(np.concatenate([p["wq"].T, p["wk"].T, p["wv"].T])),
              t(np.concatenate([p["bq"], p["bk"], p["bv"]])), t(p["wo"].T),
              t(p["bo"]), None if bias is None else t(bias)]
    for leaf in leaves:
        if leaf is not None:
            leaf.requires_grad_()
    out = twa.window_attention(*leaves[:2], torch.from_numpy(np.array(mask)),
                               *leaves[2:], *geo)
    out.backward(t(g))
    return [None if leaf is None else leaf.grad.numpy() for leaf in leaves]


def _assert_grads(got, want):
    for name, a, b in zip(("x", "pos", "in_proj_weight", "in_proj_bias",
                           "out_weight", "out_bias", "bias"), got, want):
        if b is None:
            assert a is None, name
            continue
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(
            a, b, rtol=RTOL, atol=ATOL + ATOL_OF_MAX * np.abs(b).max(),
            err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_grads_match_xla_vjp(case):
    (x, pos, mask, p, bias, g), geo = _inputs(0, *CASES[case])
    want = _jax_grads(lambda *a: jwa.window_attention_xla(*a, *geo),
                      x, pos, mask, p, bias, g)
    _assert_grads(_port_grads(x, pos, mask, p, bias, g, geo), want)


@pytest.mark.parametrize("case", ["window_l16", "grid_l24_4x6"])
def test_plain_grads_match_pallas_interpret_vjp(monkeypatch, case):
    """One window per Pallas program, fewer than the row holds (n_win_w =
    6), as tests/test_window_attn.py forces it: the kernel's chunked mask
    blocks on the forward, its custom VJP on the backward."""
    monkeypatch.setattr(jwa, "pick_windows_per_program",
                        lambda *a, **k: 1)
    (x, pos, mask, p, bias, g), geo = _inputs(1, *CASES[case])
    want = _jax_grads(
        lambda *a: jwa.window_attention_pallas(*a, *geo, True),
        x, pos, mask, p, bias, g)
    _assert_grads(_port_grads(x, pos, mask, p, bias, g, geo), want)


def test_opened_window_passes_gradients():
    """A fully padded window is opened in the forward: its keys get
    gradients like live ones (JAX's VJP does not zero them)."""
    (x, pos, mask, p, bias, g), geo = _inputs(2, *CASES["window_l16"])
    got = _port_grads(x, pos, mask, p, bias, g, geo)
    dead = got[0][-1, :4, :4]
    assert np.abs(dead).min() > 0.0
    live_pad = got[0][0, 4:8, -3:]      # padded keys of a live window:
    assert np.abs(live_pad).max() > 0.0  # gradients reach them as queries


def test_plain_version_gradcheck_float64():
    """The plain backward is itself right: finite differences in float64
    on a tiny map with a padded key column and a fully padded window."""
    (x, pos, mask, p, bias, _), geo = _inputs(
        3, 1, 4, 4, 8, 2, 2, False, True, True)
    mask[0, 2:, 3] = True
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).double()
    args = [t(x), t(pos),
            t(np.concatenate([p["wq"].T, p["wk"].T, p["wv"].T])),
            t(np.concatenate([p["bq"], p["bk"], p["bv"]])), t(p["wo"].T),
            t(p["bo"]), t(bias)]
    args = [a.requires_grad_() for a in args]
    m = torch.from_numpy(mask)
    assert torch.autograd.gradcheck(
        lambda *a: twa.window_attention_torch(a[0], a[1], m, *a[2:], *geo),
        args, eps=1e-6, atol=1e-5)
