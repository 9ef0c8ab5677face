"""The port's windowed and hybrid encoders against the JAX package
(float32, CPU, tiny widths).

JAX parameter trees are made with ``jax.eval_shape`` of the JAX module's
init and filled from a numpy seed (LayerNorm scales around one), then
loaded into the port module through ``state_dict_from_jax`` with
``strict=True``; both sides run on the same numpy inputs.  The pyramid has
odd level sizes that are not exactly twice the next (17 -> 9 -> 5 -> 3), so
the zero-padded bottom-up pool and the half-pixel nearest upsample are
exercised, and batch 1 has fully padded windows at level 0.  Tolerance:
atol/rtol 1e-5 for modules (float32 sums in another order); index maps and
the eval cache's position maps are exact.  The JAX side runs its XLA route,
and in marked cases its Pallas kernel in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memotr_tpu.models import eval_cache as jec
from memotr_tpu.models import hybrid_encoder as jhy
from memotr_tpu.models import windowed_encoder as jwe
from memotr_tpu.models.transformer import valid_ratios_from_masks
from memotr_tpu_torch.checkpoint.convert import state_dict_from_jax
from memotr_tpu_torch.models import eval_cache as tec
from memotr_tpu_torch.models import hybrid_encoder as thy
from memotr_tpu_torch.models import windowed_encoder as twe
from memotr_tpu_torch.models.layers import Linear

B, C, HEADS, FFN, WIN = 2, 32, 4, 64, 4
SHAPES = ((12, 17), (6, 9), (3, 5), (2, 3))
TOL = dict(rtol=1e-5, atol=1e-5)


def fill(tree, seed, std=0.2):
    """Every leaf from a numpy seed; LayerNorm scales around one."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        v = rng.normal(size=s.shape).astype(np.float32) * std
        return v + 1.0 if jax.tree_util.keystr(path).endswith("['scale']") \
            else v
    return jax.tree_util.tree_map_with_path(leaf, tree)


def enc_tree(module, seed, args, std=0.2):
    """Filled parameter tree of a JAX encoder called with ``args`` (src,
    static spatial shapes, valid ratios, pos, padding mask)."""
    src, shapes, *rest = args
    init = lambda key, a, *r: module.init(key, a, shapes, *r)  # noqa: E731
    return fill(jax.eval_shape(init, jax.random.PRNGKey(0), src, *rest)
                ["params"], seed, std)


def load_port(module, tree, jax_path, torch_prefix):
    """Load the JAX sub-tree found at ``jax_path`` of the model tree into
    the port ``module`` (its state dict keys under ``torch_prefix``)."""
    for key in reversed(jax_path):
        tree = {key: tree}
    sd = state_dict_from_jax(tree, {}, {})
    module.load_state_dict({k[len(torch_prefix):]: v for k, v in sd.items()},
                           strict=True)
    return module.eval()


def level_inputs(seed, shapes=SHAPES, c=C):
    """Per-level x, pos and masks: batch 0 padded at the bottom rows,
    batch 1 at the right columns (fully padded windows at level 0)."""
    rng = np.random.default_rng(seed)
    xs, poss, masks = [], [], []
    for h, w in shapes:
        xs.append(rng.normal(size=(B, h, w, c)).astype(np.float32))
        poss.append((rng.normal(size=(B, h, w, c)) * 0.5).astype(np.float32))
        m = np.zeros((B, h, w), bool)
        m[0, -(-h * 8 // 10):] = True
        m[1, :, -(-w * 7 // 10):] = True
        masks.append(m)
    return xs, poss, masks


def flat(levels):
    return np.concatenate([a.reshape(a.shape[0], -1, *a.shape[3:])
                           for a in levels], axis=1)


def t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def j(arrays):
    return [jnp.asarray(a) for a in arrays]


# ------------------------------------------------------------ layers
@pytest.mark.parametrize("grid,impl", [(False, "xla"), (True, "xla"),
                                       (False, "pallas"), (True, "pallas")])
def test_layer_matches_jax(grid, impl):
    xs, poss, masks = level_inputs(0)
    jl = jwe.WindowedEncoderLayer(C, FFN, HEADS, WIN, grid=grid,
                                  attn_impl=impl)
    tree = fill(jax.eval_shape(jl.init, jax.random.PRNGKey(0), j(xs),
                               j(masks), j(poss))["params"], 1)
    want = jl.apply({"params": tree}, j(xs), j(masks), j(poss))
    tl = load_port(twe.WindowedEncoderLayer(C, FFN, HEADS, len(SHAPES), WIN,
                                            grid=grid),
                   tree, ("transformer", "encoder", "layer_0"),
                   "transformer.encoder.layers.0.")
    with torch.no_grad():
        got = tl(t(xs), t(masks), t(poss), tl.bias_tables(SHAPES))
    for lvl, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=f"level {lvl}")


@pytest.mark.parametrize("prenorm,shared_cpb", [(False, False), (True, False),
                                                (False, True), (True, True)])
def test_encoder_matches_jax(prenorm, shared_cpb):
    xs, poss, masks = level_inputs(2)
    src, pos, pad = flat(xs), flat(poss), flat(masks)
    vr = np.array(valid_ratios_from_masks(j(masks)))
    je = jwe.WindowedEncoder(2, C, FFN, HEADS, WIN, prenorm=prenorm,
                             shared_cpb=shared_cpb)
    args = (jnp.asarray(src), SHAPES, jnp.asarray(vr), jnp.asarray(pos),
            jnp.asarray(pad))
    tree = enc_tree(je, 3, args, std=0.1)
    want = je.apply({"params": tree}, *args)
    te = load_port(twe.WindowedEncoder(2, C, FFN, HEADS, len(SHAPES), WIN,
                                       prenorm=prenorm,
                                       shared_cpb=shared_cpb),
                   tree, ("transformer", "encoder"), "transformer.encoder.")
    with torch.no_grad():
        got = te(torch.from_numpy(src), SHAPES, torch.from_numpy(vr),
                 torch.from_numpy(pos), torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("deform_min_level", [1, 2])
def test_hybrid_encoder_matches_jax(deform_min_level):
    xs, poss, masks = level_inputs(4)
    src, pos, pad = flat(xs), flat(poss), flat(masks)
    vr = np.array(valid_ratios_from_masks(j(masks)))
    je = jhy.HybridEncoder(2, C, FFN, HEADS, n_points=2,
                           deform_min_level=deform_min_level, window=WIN,
                           msda_impl="xla")
    args = (jnp.asarray(src), SHAPES, jnp.asarray(vr), jnp.asarray(pos),
            jnp.asarray(pad))
    tree = enc_tree(je, 5, args, std=0.1)
    want = je.apply({"params": tree}, *args)
    te = load_port(thy.HybridEncoder(2, C, FFN, HEADS, len(SHAPES), 2,
                                     deform_min_level, WIN),
                   tree, ("transformer", "encoder"), "transformer.encoder.")
    with torch.no_grad():
        got = te(torch.from_numpy(src), SHAPES, torch.from_numpy(vr),
                 torch.from_numpy(pos), torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------ cross-level fusion
@pytest.mark.parametrize("n_in,n_out", [(13, 25), (7, 13), (3, 6), (5, 17)])
def test_nearest_upsample_is_jax_resize(n_in, n_out):
    """Half-pixel centres: at 13 -> 25, output row 13 reads row 7 (the
    floor(i * in / out) rule of F.interpolate would read row 6)."""
    a = np.random.default_rng(6).normal(size=(1, n_in, n_in + 2, 3)
                                        ).astype(np.float32)
    want = jax.image.resize(jnp.asarray(a), (1, n_out, n_out + 3, 3),
                            "nearest")
    got = twe.nearest_upsample(torch.from_numpy(a), n_out, n_out + 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bottomup", [True, False])
def test_cross_level_fuse_odd_sizes(bottomup):
    """The flagship's coarse end, 25 -> 13 -> 7 -> 4 rows: every bottom-up
    step zero-pads the finer level and averages the zeros in."""
    shapes = ((25, 48), (13, 24), (7, 12), (4, 6))
    xs, _, _ = level_inputs(7, shapes, c=8)
    rng = np.random.default_rng(8)
    mix = {}
    for name in ("td", "bu"):
        mix[name] = (rng.normal(size=(8, 8)).astype(np.float32) * 0.3,
                     rng.normal(size=(8,)).astype(np.float32) * 0.1)

    def jdense(name):
        k, b = mix[name]
        return lambda x: x @ jnp.asarray(k) + jnp.asarray(b)

    def tlinear(name):
        lin = Linear(8, 8)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(mix[name][0].T.copy()))
            lin.bias.copy_(torch.from_numpy(mix[name][1]))
        return lin
    want = jwe.cross_level_fuse(j(xs), jdense("td"),
                                jdense("bu") if bottomup else None,
                                jnp.float32)
    with torch.no_grad():
        got = twe.cross_level_fuse(t(xs), tlinear("td"),
                                   tlinear("bu") if bottomup else None)
    for lvl, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=f"level {lvl}")


# ------------------------------------------------------------ eval cache
@pytest.mark.parametrize("n_h,n_w,scale", [(4, 4, 1), (5, 7, 4), (13, 24, 8)])
def test_relpos_table_is_jax(n_h, n_w, scale):
    for got, want in zip(twe.relpos_table(n_h, n_w, scale),
                         jwe._relpos_table(n_h, n_w, scale)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shared_cpb", [False, True])
def test_eval_cache_tables_match_jax(shared_cpb):
    """Per-layer, per-level CPB tables (window and grid layers) against the
    JAX package's ``cpb_tables``."""
    xs, poss, masks = level_inputs(9)
    args = (jnp.asarray(flat(xs)), SHAPES, jnp.zeros((B, len(SHAPES), 2)),
            jnp.asarray(flat(poss)), jnp.asarray(flat(masks)))
    je = jwe.WindowedEncoder(3, C, FFN, HEADS, WIN, shared_cpb=shared_cpb)
    tree = enc_tree(je, 10, args)
    want = jec.cpb_tables(tree, 3, WIN, SHAPES)
    te = load_port(twe.WindowedEncoder(3, C, FFN, HEADS, len(SHAPES), WIN,
                                       shared_cpb=shared_cpb),
                   tree, ("transformer", "encoder"), "transformer.encoder.")
    with torch.no_grad():
        got = te.bias_tables(SHAPES)
    assert len(got) == len(want) == 3
    for layer_got, layer_want in zip(got, want):
        assert len(layer_got) == len(layer_want) == len(SHAPES)
        for a, b in zip(layer_got, layer_want):
            np.testing.assert_allclose(a.numpy(), b, **TOL)


@pytest.mark.parametrize("hw", [(96, 128), (37, 53)])
def test_eval_cache_position_maps_are_jax(hw):
    """The cached position maps are the JAX cache's, bit for bit (padded
    positions included)."""
    mask = np.zeros((2,) + hw, bool)
    mask[0, hw[0] * 5 // 6:] = True
    mask[1, :, hw[1] * 3 // 4:] = True
    assert tec.pyramid_shapes(*hw) == jec.pyramid_shapes(*hw)
    for h, w in tec.pyramid_shapes(*hw):
        md = tec.np_downsample_mask(mask, h, w)
        np.testing.assert_array_equal(md, jec.np_downsample_mask(mask, h, w))
        np.testing.assert_array_equal(
            tec.np_sine_position_embedding(md, 16),
            jec.np_sine_position_embedding(md, 16))
