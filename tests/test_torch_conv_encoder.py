"""The port's conv encoder (``ENCODER_TYPE: conv``) against the JAX
package (float32, CPU).

- ``ConvEncoder`` on ``tests/test_conv_encoder.py``'s pyramid (16x24 ..
  2x3, C=32, FFN 64, 2 layers), batch 0 padded at its bottom rows and
  batch 1 at its right columns: the forward (1e-5) and ``jax.vjp``'s
  gradients of the input and of every parameter (within 1e-5 of each
  gradient's largest element: float32 sums in another order), the JAX
  tree loaded into the port through ``state_dict_from_jax`` (the conv
  kernel HWIO -> OIHW) with ``strict=True``.  Padded pixels do not reach
  a layer's conv.
- Three frames of ``eval_frame_step`` of a tiny conv MeMOTR against JAX's,
  with each side's eval cache, checked as ``test_torch_windowed_slice.py``
  checks the windowed model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memotr_tpu.engine.submit import _maybe_normalize
from memotr_tpu.models.conv_encoder import ConvEncoder as JaxConvEncoder
from memotr_tpu.models.eval_cache import attach_eval_cache
from memotr_tpu.models.frame_step import eval_frame_step as jax_eval_step
from memotr_tpu.models.memotr import build_model as jax_build_model
from memotr_tpu.models.query_updater import build_query_updater
from memotr_tpu.structures.padded_frame import PaddedFrames
from memotr_tpu.structures.track_state import TrackState as JaxTrackState
from memotr_tpu_torch.checkpoint.convert import state_dict_from_jax
from memotr_tpu_torch.engine.submit import normalize_uint8
from memotr_tpu_torch.models.conv_encoder import ConvEncoder
from memotr_tpu_torch.models.eval_cache import EvalCache
from memotr_tpu_torch.models.frame_step import eval_frame_step, model_forward
from memotr_tpu_torch.models.windowed_encoder import split_levels
from memotr_tpu_torch.structures.track_state import TrackState
from test_torch_port_weights import HD, ND, SLOTS, TINY_CFG
from test_torch_slice import MARGIN, N_FRAMES, THRESH, _frames
from test_torch_submit import one_torch_thread  # noqa: F401
from test_torch_windowed import fill, load_port
from test_torch_windowed_slice import jax_trees, port_model

SHAPES = ((16, 24), (8, 12), (4, 6), (2, 3))
B, C, FFN, LAYERS = 2, 32, 64, 2
GRAD_REL = 1e-5


def _inputs(seed):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in SHAPES)
    src = rng.normal(size=(B, s, C)).astype(np.float32)
    pos = rng.normal(size=(B, s, C)).astype(np.float32)
    masks = []
    for h, w in SHAPES:
        m = np.zeros((B, h, w), bool)
        m[0, -(-h * 3 // 10):] = True
        m[1, :, -(-w * 4 // 10):] = True
        masks.append(m.reshape(B, -1))
    return src, pos, np.concatenate(masks, axis=1)


@pytest.fixture(scope="module")
def encoders():
    src, pos, mask = _inputs(0)
    jenc = JaxConvEncoder(LAYERS, C, FFN, dtype=jnp.float32)
    shape = jax.eval_shape(lambda k: jenc.init(k, src, SHAPES, None, pos,
                                               mask), jax.random.PRNGKey(0))
    tree = fill(shape["params"], seed=1)
    port = load_port(ConvEncoder(LAYERS, C, FFN, len(SHAPES)), tree,
                     ["transformer", "encoder"], "transformer.encoder.")
    return jenc, tree, port


def _port_out(port, src, pos, mask):
    return port(src, SHAPES, None, torch.from_numpy(pos),
                torch.from_numpy(mask))


def test_forward_matches_jax(encoders):
    jenc, tree, port = encoders
    src, pos, mask = _inputs(0)
    want = jenc.apply({"params": tree}, src, SHAPES, None, pos, mask)
    with torch.no_grad():
        got = _port_out(port, torch.from_numpy(src), pos, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_gradients_match_jax_vjp(encoders):
    jenc, tree, port = encoders
    src, pos, mask = _inputs(0)
    ct = np.random.default_rng(2).normal(size=src.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p, s: jenc.apply({"params": p}, s, SHAPES, None,
                                             pos, mask), tree, src)
    g_tree, g_src = vjp(jnp.asarray(ct))
    want = {k[len("transformer.encoder."):]: v.numpy() for k, v in
            state_dict_from_jax({"transformer": {"encoder": jax.tree_util.
                                                 tree_map(np.array, g_tree)}},
                                {}, {}).items()}
    want["src"] = np.asarray(g_src)
    x = torch.from_numpy(src).requires_grad_()
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad(_port_out(port, x, pos, mask),
                                (x,) + params, torch.from_numpy(ct))
    got = dict(zip(("src",) + names, grads))
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=name)


def test_padded_pixels_do_not_reach_the_conv(encoders):
    """A layer's level-0 outputs on valid pixels are exactly unchanged when
    its level-0 inputs change on padded pixels (batch 1's right columns):
    the conv reads zeros there.  (Across layers the fusion's pooling does
    carry padded pixels into valid ones where the levels' padding does not
    line up, in the JAX encoder as in the port.)"""
    _, _, port = encoders
    src, _, mask = _inputs(0)
    levels = split_levels(torch.from_numpy(src), SHAPES)
    masks = split_levels(torch.from_numpy(mask), SHAPES)
    first_pad = -(-SHAPES[0][1] * 4 // 10)   # as _inputs pads batch 1
    pert = [lv.clone() for lv in levels]
    # not a constant shift, which the LayerNorm would remove
    noise = np.random.default_rng(3).normal(size=pert[0][1, :, first_pad:]
                                            .shape).astype(np.float32)
    pert[0][1, :, first_pad:] += 100.0 * torch.from_numpy(noise)
    with torch.no_grad():
        a = port.layers[0](levels, masks)[0][1, :, :first_pad]
        b = port.layers[0](pert, masks)[0][1, :, :first_pad]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


CFG = dict(TINY_CFG, ENCODER_TYPE="conv", MISS_TOLERANCE=2)


@pytest.fixture(scope="module")
def runs():
    trees = jax_trees(CFG, seed=16)
    params, uparams, frozen = trees
    model = port_model(CFG, trees)
    jmodel, jupd = jax_build_model(CFG), build_query_updater(CFG)
    frames = _frames()
    variables = attach_eval_cache(jmodel, {"params": params,
                                           "frozen": frozen},
                                  frames[0]["mask"].shape,
                                  frames[0]["mask"][None])

    @jax.jit
    def jax_step(images, mask, state):
        fr = PaddedFrames(images=_maybe_normalize(images), mask=mask)
        return jax_eval_step(jmodel, jupd, variables, {"params": uparams},
                             fr, state, ND, THRESH, THRESH,
                             CFG["MISS_TOLERANCE"])

    cache = EvalCache(model, "cpu")
    jst = JaxTrackState.empty(1, SLOTS, HD, 1)
    st = TrackState.empty(1, SLOTS, HD, 1)
    out = {"jax": [], "port": [], "margins": []}
    with torch.inference_mode():
        for fr in frames:
            img = normalize_uint8(torch.from_numpy(fr["image"])[None])
            mask = torch.from_numpy(fr["mask"])[None]
            ctx = cache.lookup(fr["mask"][None])
            fwd = model_forward(model, img, mask, st, ctx)
            scores = torch.sigmoid(fwd["pred_logits"][0, :, 0])
            out["margins"] += (scores[:ND] - THRESH).abs().tolist()
            out["margins"] += (scores[ND:][st.mask[0]] - THRESH).abs().tolist()
            res, st = eval_frame_step(model, img, mask, st, THRESH, THRESH,
                                      CFG["MISS_TOLERANCE"], ctx)
            out["margins"] += (res["scores"][res["mask"]] - THRESH
                               ).abs().tolist()
            jres, jst = jax_step(jnp.asarray(fr["image"])[None],
                                 jnp.asarray(fr["mask"])[None], jst)
            out["port"].append(({k: v.numpy() for k, v in res.items()}, st))
            out["jax"].append(({k: np.asarray(v) for k, v in jres.items()},
                               jax.tree_util.tree_map(np.asarray, jst)))
    return out


def test_conv_slice_exercises_tracks(runs):
    assert min(runs["margins"]) >= MARGIN
    assert any(r["mask"].any() for r, _ in runs["port"])


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_conv_frame_step_matches_jax(runs, frame):
    (res, st), (jres, jst) = runs["port"][frame], runs["jax"][frame]
    for key in ("ids", "labels", "mask"):
        np.testing.assert_array_equal(res[key], jres[key], err_msg=key)
    np.testing.assert_array_equal(st.next_id.numpy(), jst.next_id)
    np.testing.assert_allclose(st.logits.numpy(), jst.logits, atol=1e-4)
    np.testing.assert_allclose(res["boxes"], jres["boxes"], atol=1e-5)
    np.testing.assert_allclose(st.ref_pts.numpy(), jst.ref_pts, atol=1e-5)
