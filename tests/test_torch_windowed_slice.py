"""The windowed and hybrid models end to end against the JAX package
(float32, CPU), and the eval cache's per-frame mask guard.

- Three frames of ``eval_frame_step`` on a tiny windowed MeMOTR (2 encoder
  layers: one window, one grid; window 4; 3 decoder layers; 30 detection
  queries; 4 slots) on the padded 96x128 canvas of tests/test_torch_slice.py,
  the port with its ``EvalCache`` and the JAX package with
  ``attach_eval_cache``.  Ids, labels, slot masks and next_id identical;
  logits 1e-4; boxes and ref_pts 1e-5; every score compared with a
  threshold clears it by at least 1e-3.
- One frame of the hybrid model's forward, logits 1e-4 and boxes 1e-5, on
  a canvas padded in its bottom-right corner.  (Where whole rows or columns
  are padding, the sine embedding divides by eps there and any two
  implementations disagree; the cross-level fusion carries those pixels
  into valid ones, so the uncached comparison avoids such canvases.)
- The mask guard: a frame whose padding mask differs from the cached one
  gets fresh constants, i.e. the result of the uncached forward.

The JAX trees are filled from a numpy seed (parameters N(0, 0.08^2), norms
around one, unit-scale detection queries, positive BN variances) and loaded
into the port through ``state_dict_from_jax`` with ``strict=True``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memotr_tpu.engine.submit import _maybe_normalize
from memotr_tpu.models.eval_cache import attach_eval_cache
from memotr_tpu.models.frame_step import eval_frame_step as jax_eval_step
from memotr_tpu.models.memotr import build_model as jax_build_model
from memotr_tpu.models.query_updater import build_query_updater
from memotr_tpu.structures.padded_frame import PaddedFrames
from memotr_tpu.structures.track_state import TrackState as JaxTrackState
from memotr_tpu_torch.checkpoint.convert import state_dict_from_jax
from memotr_tpu_torch.engine.submit import normalize_uint8
from memotr_tpu_torch.models.eval_cache import EvalCache
from memotr_tpu_torch.models.frame_step import eval_frame_step, model_forward
from memotr_tpu_torch.models.memotr import build_model
from memotr_tpu_torch.structures.track_state import TrackState
from test_torch_port_weights import HD, ND, SLOTS, TINY_CFG
from test_torch_slice import MARGIN, N_FRAMES, THRESH, _frames

CFG = dict(TINY_CFG, ENCODER_TYPE="windowed", WINDOW_SIZE=4,
           MISS_TOLERANCE=2)
HYBRID_CFG = dict(CFG, ENCODER_TYPE="hybrid")


def jax_trees(cfg, seed):
    """(params, uparams, frozen) of the JAX model, filled from ``seed``."""
    model, updater = jax_build_model(cfg), build_query_updater(cfg)
    st = JaxTrackState.empty(1, SLOTS, HD, 1)
    variables = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32),
        jax.ShapeDtypeStruct((1, 64, 64), bool), st.query_embed, st.ref_pts,
        st.mask)
    uvars = jax.eval_shape(updater.init, jax.random.PRNGKey(1),
                           st.query_embed, st.ref_pts, st.logits, st.boxes,
                           st.output_embed, st.last_output, st.long_memory,
                           st.mask)
    rng = np.random.default_rng(seed)

    def param(path, s):
        name = jax.tree_util.keystr(path)
        v = rng.normal(size=s.shape).astype(np.float32) * 0.08
        if name.endswith("['scale']"):
            v += 1.0
        if name in ("['det_query_embed']", "['det_anchor']"):
            v *= 12.5
        return v

    def frozen(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['running_var']"):
            return rng.uniform(0.5, 1.5, size=s.shape).astype(np.float32)
        v = rng.normal(size=s.shape).astype(np.float32) * 0.3
        return v + 1.0 if name.endswith("['weight']") else v

    fill = jax.tree_util.tree_map_with_path
    return (fill(param, variables["params"]), fill(param, uvars["params"]),
            fill(frozen, variables["frozen"]))


def port_model(cfg, trees):
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(*trees), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def runs():
    trees = jax_trees(CFG, seed=11)
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
    out["builds"] = cache.builds
    return out


def test_windowed_slice_exercises_tracks_and_cache(runs):
    assert min(runs["margins"]) >= MARGIN
    assert any(r["mask"].any() for r, _ in runs["port"])
    assert runs["builds"] == 1          # one canvas mask for the sequence


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_windowed_frame_step_matches_jax(runs, frame):
    (res, st), (jres, jst) = runs["port"][frame], runs["jax"][frame]
    for key in ("ids", "labels", "mask"):
        np.testing.assert_array_equal(res[key], jres[key], err_msg=key)
    np.testing.assert_array_equal(st.next_id.numpy(), jst.next_id)
    np.testing.assert_allclose(st.logits.numpy(), jst.logits, atol=1e-4)
    np.testing.assert_allclose(res["boxes"], jres["boxes"], atol=1e-5)
    np.testing.assert_allclose(st.ref_pts.numpy(), jst.ref_pts, atol=1e-5)


def _corner_padded_frame():
    """A frame padded in its bottom-right corner only: no row or column is
    all padding."""
    fr = dict(_frames()[0])
    mask = np.zeros((96, 128), bool)
    mask[72:, 96:] = True
    img = fr["image"].copy()
    img[mask] = 0
    return img, mask


def _track_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, SLOTS, HD)).astype(np.float32),
            rng.normal(size=(1, SLOTS, 4)).astype(np.float32),
            np.asarray([[True, False, True, True]]))


def test_hybrid_forward_matches_jax():
    trees = jax_trees(HYBRID_CFG, seed=12)
    params, _, frozen = trees
    model = port_model(HYBRID_CFG, trees)
    img, mask = _corner_padded_frame()
    img = normalize_uint8(torch.from_numpy(img)[None])
    tq, tr, tm = _track_inputs(13)
    with torch.inference_mode():
        out = model(img, torch.from_numpy(mask)[None], torch.from_numpy(tq),
                    torch.from_numpy(tr), torch.from_numpy(tm))
    jout = jax.jit(jax_build_model(HYBRID_CFG).apply)(
        {"params": params, "frozen": frozen}, jnp.asarray(img.numpy()),
        jnp.asarray(mask)[None], jnp.asarray(tq), jnp.asarray(tr),
        jnp.asarray(tm))
    for key, tol in (("pred_logits", 1e-4), ("pred_boxes", 1e-5),
                     ("outputs", 1e-4)):
        assert np.isfinite(out[key].numpy()).all()
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   atol=tol, err_msg=key)


def test_eval_cache_rebuilds_for_a_new_mask():
    """Frames with masks A, A, B: the cache builds twice, and frame B's
    result is the uncached one (stale constants would give another)."""
    model = port_model(CFG, jax_trees(CFG, seed=14))
    img_b, mask_b = _corner_padded_frame()
    mask_a = np.zeros_like(mask_b)
    tq, tr, tm = (torch.from_numpy(a) for a in _track_inputs(15))
    cache = EvalCache(model, "cpu")
    img = normalize_uint8(torch.from_numpy(img_b)[None])

    def forward(mask, ctx):
        return model(img, torch.from_numpy(mask)[None], tq, tr, tm, ctx)

    with torch.inference_mode():
        stale = cache.lookup(mask_a[None])
        assert cache.lookup(mask_a[None]) is stale and cache.builds == 1
        fresh = cache.lookup(mask_b[None])
        assert cache.builds == 2
        got = forward(mask_b, fresh)
        want = forward(mask_b, None)
        wrong = forward(mask_b, stale)
    for key, tol in (("pred_logits", 1e-4), ("pred_boxes", 1e-5)):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=tol, err_msg=key)
    assert (wrong["pred_logits"] - want["pred_logits"]).abs().max() > 1e-3
