"""The port's matching and losses against the JAX package (float32, CPU).

Box ops, ``hungarian_cost_padded`` (padded rows, inf and NaN cells), the
focal matching cost, the cost matrix, the focal loss, the assignment
inversion, and ``ClipCriterion.process_frame`` on one model-output dict
with live, vanished and newborn identities, aux layers on both sides of
the merge layer.  Inputs from a numpy seed; assignments, identities and
masks must be identical, float values agree to rtol 1e-5 / atol 1e-6
(float32 in another order, a few ops deep).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memotr_tpu.models import criterion as jcrit
from memotr_tpu.ops.hungarian import hungarian_cost_padded as jax_hungarian
from memotr_tpu.structures.track_state import TrackState as JaxTrackState
from memotr_tpu.utils import box_ops as jbox
from memotr_tpu_torch.models import criterion as pcrit
from memotr_tpu_torch.ops import hungarian
from memotr_tpu_torch.structures.track_state import TrackState
from memotr_tpu_torch.utils import box_ops as pbox

TOL = dict(rtol=1e-5, atol=1e-6)


def _boxes(rng, *shape):
    """cxcywh boxes inside the unit square, some degenerate (w or h 0)."""
    c = rng.uniform(0.2, 0.8, shape + (2,))
    wh = rng.uniform(0.0, 0.3, shape + (2,))
    wh[..., 0][rng.uniform(size=shape) < 0.1] = 0.0
    return np.concatenate([c, wh], -1).astype(np.float32)


@pytest.mark.parametrize("name", [
    "box_xyxy_to_cxcywh", "box_cxcywh_to_xyxy", "box_area", "box_iou_union",
    "generalized_box_iou", "box_iou_pairwise", "generalized_box_iou_pairwise"])
def test_box_ops_match_jax(name):
    rng = np.random.default_rng(0)
    a = jbox.box_cxcywh_to_xyxy(_boxes(rng, 2, 5))
    b = jbox.box_cxcywh_to_xyxy(_boxes(rng, 2, 7 if "pairwise" not in name
                                       else 5))
    a, b = np.array(a), np.array(b)
    unary = name in ("box_xyxy_to_cxcywh", "box_cxcywh_to_xyxy", "box_area")
    args = (a,) if unary else (a, b)
    want = getattr(jbox, name)(*map(jnp.asarray, args))
    got = getattr(pbox, name)(*map(torch.from_numpy, args))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _costs(seed, lead=(3,), r=6, c=10):
    rng = np.random.default_rng(seed)
    cost = rng.normal(size=lead + (r, c)).astype(np.float32)
    rows = rng.uniform(size=lead + (r,)) < 0.7
    rows[..., 0] = True
    cost[rng.uniform(size=cost.shape) < 0.1] = np.inf
    cost.reshape(-1)[3] = np.nan
    return cost, rows


@pytest.mark.parametrize("lead", [(3,), (2, 3)])
def test_hungarian_matches_jax(lead):
    """Identical assignments, -1 on padded rows; every problem of the call
    crosses to the host in one copy."""
    cost, rows = _costs(1, lead)
    want = np.asarray(jax_hungarian(jnp.asarray(cost), jnp.asarray(rows)))
    before = hungarian.host_copies
    got = hungarian.hungarian_cost_padded(torch.from_numpy(cost),
                                          torch.from_numpy(rows))
    assert hungarian.host_copies == before + 1
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[~rows] == -1).all()


def test_hungarian_all_rows_padded_and_all_forbidden():
    cost = np.full((2, 3, 4), np.inf, np.float32)
    rows = np.asarray([[False] * 3, [True, True, False]])
    want = np.asarray(jax_hungarian(jnp.asarray(cost), jnp.asarray(rows)))
    got = hungarian.hungarian_cost_padded(torch.from_numpy(cost),
                                          torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy()[~rows], -1)
    # all cells forbidden: any one-to-one assignment is optimal
    assert len(set(got.numpy()[1, :2])) == 2 and \
        len(set(want[1, :2])) == 2


def _frame(seed, b=2, nd=6, s=3, g=4, k=1, c=8, n_layers=3):
    """A model-output dict, a track state and a FrameGT, as numpy."""
    rng = np.random.default_rng(seed)
    n = nd + s
    out = {
        "pred_boxes": _boxes(rng, b, n),
        "pred_logits": rng.normal(0, 2, (b, n, k)).astype(np.float32),
        "outputs": rng.normal(size=(b, n, c)).astype(np.float32),
        "queries": rng.normal(size=(n_layers, b, n, c)).astype(np.float32),
        "last_ref_pts": rng.normal(size=(b, n, 4)).astype(np.float32),
        "init_ref_pts": rng.normal(size=(b, n, 4)).astype(np.float32),
        "det_query_embed": rng.normal(size=(nd, c)).astype(np.float32),
        "query_mask": np.concatenate(
            [np.zeros((b, nd), bool), [[False, False, True]] * b], 1),
        "all_logits": rng.normal(0, 2, (n_layers, b, n, k)).astype(np.float32),
        "all_boxes": _boxes(rng, n_layers, b, n),
    }
    out["all_logits"][-1] = out["pred_logits"]
    out["all_boxes"][-1] = out["pred_boxes"]
    gt = {"boxes": _boxes(rng, b, g),
          "labels": rng.integers(0, k, (b, g)).astype(np.int32),
          "ids": np.asarray([[100, 101, 102, -1], [200, 201, -1, -1]],
                            np.int32),
          "mask": np.asarray([[True, True, True, False],
                              [True, True, False, False]])}
    # slot 0 follows a live identity, slot 1 one that vanished, slot 2 free
    st = {"mask": np.asarray([[True, True, False]] * b),
          "ids": np.asarray([[101, 105, -1], [200, 207, -1]], np.int32),
          "iou": rng.uniform(size=(b, s)).astype(np.float32),
          "boxes": _boxes(rng, b, s),
          "logits": rng.normal(size=(b, s, k)).astype(np.float32),
          "output_embed": rng.normal(size=(b, s, c)).astype(np.float32)}
    return out, st, gt


def _run_both(seed, merge_layer, use_dab=True):
    out, st, gt = _frame(seed)
    b, s = st["mask"].shape
    c = out["outputs"].shape[-1]
    kw = dict(num_classes=1, n_det_queries=6, merge_det_track_layer=merge_layer,
              aux_weights=[1.0, 0.5], hidden_dim=c, use_dab=use_dab)
    if not use_dab:
        out = dict(out, det_query_embed=np.concatenate(
            [out["det_query_embed"]] * 2, -1))
    jst = JaxTrackState.empty(b, s, c, 1, use_dab=use_dab).replace(
        **{k: jnp.asarray(v) for k, v in st.items()})
    pst = TrackState.empty(b, s, c, 1, use_dab=use_dab).replace(
        **{k: torch.from_numpy(v) for k, v in st.items()})
    jres = jcrit.ClipCriterion(**kw).process_frame(
        {k: jnp.asarray(v) for k, v in out.items()}, jst,
        jcrit.FrameGT(**{k: jnp.asarray(v) for k, v in gt.items()}))
    pres = pcrit.ClipCriterion(**kw).process_frame(
        {k: torch.from_numpy(v) for k, v in out.items()}, pst,
        pcrit.FrameGT(**{k: torch.from_numpy(v) for k, v in gt.items()}))
    return jres, pres


def _close(got, want, name):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


@pytest.mark.parametrize("merge_layer,use_dab", [(1, True), (0, True),
                                                 (2, False)])
def test_process_frame_matches_jax(merge_layer, use_dab):
    (jl, jn, jst, jnew, jum), (pl, pn, pst, pnew, pum) = _run_both(
        3, merge_layer, use_dab)
    assert set(pl) == set(jl) and len(pl) == 6
    for k in jl:
        _close(pl[k], jl[k], k)
    _close(pn, jn, "n_gts")
    for f in ("matched_idx", "iou", "boxes", "logits", "output_embed",
              "mask", "ids"):
        _close(getattr(pst, f), getattr(jst, f), f"state.{f}")
    for name, p, j in (("new", pnew, jnew), ("um", pum, jum)):
        assert set(p) == set(j)
        for k in j:
            _close(p[k], j[k], f"{name}.{k}")


def test_process_frame_exercises_identities():
    """Slot 0 keeps its GT, slot 1's identity vanished, the rest newborn."""
    _, (_, _, pst, pnew, _) = _run_both(3, 1)
    np.testing.assert_array_equal(pst.matched_idx.numpy(), [[1, -1, -1],
                                                            [0, -1, -1]])
    np.testing.assert_array_equal(pnew["mask"].numpy(),
                                  [[True, False, True, False],
                                   [False, True, False, False]])


def test_matching_costs_and_focal_loss_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 2, (2, 7, 3)).astype(np.float32)
    boxes = _boxes(rng, 2, 7)
    gt = {"boxes": _boxes(rng, 2, 4),
          "labels": rng.integers(-1, 3, (2, 4)).astype(np.int32),
          "ids": np.zeros((2, 4), np.int32), "mask": np.ones((2, 4), bool)}
    probs = 1 / (1 + np.exp(-logits))
    _close(pcrit.focal_class_cost(torch.from_numpy(probs),
                                  torch.from_numpy(gt["labels"])),
           jcrit.focal_class_cost(jnp.asarray(probs),
                                  jnp.asarray(gt["labels"])), "focal cost")
    _close(pcrit.match_cost_matrix(
        torch.from_numpy(logits), torch.from_numpy(boxes),
        pcrit.FrameGT(**{k: torch.from_numpy(v) for k, v in gt.items()}),
        2.0, 5.0, 2.0),
        jcrit.match_cost_matrix(
            jnp.asarray(logits), jnp.asarray(boxes),
            jcrit.FrameGT(**{k: jnp.asarray(v) for k, v in gt.items()}),
            2.0, 5.0, 2.0), "cost")
    onehot = (rng.uniform(size=logits.shape) < 0.3).astype(np.float32)
    valid = rng.uniform(size=(2, 7)) < 0.8
    _close(pcrit.sigmoid_focal_loss(torch.from_numpy(logits),
                                    torch.from_numpy(onehot),
                                    torch.from_numpy(valid)),
           jcrit.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(onehot),
                                    jnp.asarray(valid)), "focal loss")
    col4row = np.asarray([[3, -1, 0, 5], [1, 2, -1, 4]], np.int32)
    rows = np.asarray([[True, True, True, False], [True, True, False, True]])
    _close(pcrit._invert_assignment(torch.from_numpy(col4row),
                                    torch.from_numpy(rows), 7),
           jcrit._invert_assignment(jnp.asarray(col4row), jnp.asarray(rows),
                                    7), "invert")
