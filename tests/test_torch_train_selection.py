"""Training-time track selection against the JAX package (float32, CPU).

``select_active_tracks_train`` on one state and candidate set, built from a
numpy seed: the default path, TP-drop at ratio 1.0 and FP-insert at ratio
1.0 (where ``uniform <= 1`` and ``uniform < 1`` make both packages'
draws decide alike).  Every slot field must agree (identities and masks
exactly, floats to 1e-6), except where the fake-track fallback fires:
there its random track differs by design and only ``mask`` and ``ids``
are compared.  Scores and IoUs sit at least 0.02 from the thresholds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memotr_tpu.models.track_selection import \
    select_active_tracks_train as jax_select
from memotr_tpu.structures.track_state import TrackState as JaxTrackState
from memotr_tpu_torch.models.track_selection import select_active_tracks_train
from memotr_tpu_torch.structures.track_state import SLOT_FIELDS, TrackState

B, S, G, ND, C = 2, 6, 3, 5, 4


def _logits(rng, *shape):
    """Logits whose sigmoid is at least 0.02 from 0.5."""
    x = rng.uniform(0.1, 3.0, shape) * rng.choice([-1, 1], shape)
    return x.astype(np.float32)


def _boxes(rng, *shape):
    c = rng.uniform(0.2, 0.8, shape + (2,))
    wh = rng.uniform(0.05, 0.3, shape + (2,))
    return np.concatenate([c, wh], -1).astype(np.float32)


def _iou(rng, *shape):
    """IoU values at least 0.1 from 0.5."""
    return rng.choice([0.1, 0.3, 0.7, 0.9], shape).astype(np.float32)


def _cand(rng, n, with_ids):
    ids = rng.integers(0, 50, (B, n)).astype(np.int32) if with_ids \
        else np.full((B, n), -1, np.int32)
    return {"mask": rng.uniform(size=(B, n)) < 0.7, "ids": ids,
            "labels": np.zeros((B, n), np.int32),
            "matched_idx": np.full((B, n), -1, np.int32),
            "query_embed": rng.normal(size=(B, n, C)).astype(np.float32),
            "ref_pts": rng.normal(size=(B, n, 4)).astype(np.float32),
            "output_embed": rng.normal(size=(B, n, C)).astype(np.float32),
            "boxes": _boxes(rng, B, n), "logits": _logits(rng, B, n, 1),
            "iou": _iou(rng, B, n) if with_ids else np.zeros((B, n),
                                                            np.float32),
            "last_output": rng.normal(size=(B, n, C)).astype(np.float32),
            "long_memory": rng.normal(size=(B, n, C)).astype(np.float32)}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    st = {"mask": np.asarray([[1, 1, 1, 0, 1, 0], [0, 1, 1, 0, 0, 0]], bool),
          "ids": rng.integers(-1, 30, (B, S)).astype(np.int32),
          "labels": np.zeros((B, S), np.int32),
          "query_embed": rng.normal(size=(B, S, C)).astype(np.float32),
          "ref_pts": rng.normal(size=(B, S, 4)).astype(np.float32),
          "logits": _logits(rng, B, S, 1), "boxes": _boxes(rng, B, S),
          "output_embed": rng.normal(size=(B, S, C)).astype(np.float32),
          "last_output": rng.normal(size=(B, S, C)).astype(np.float32),
          "long_memory": rng.normal(size=(B, S, C)).astype(np.float32),
          "matched_idx": rng.integers(-1, G, (B, S)).astype(np.int32),
          "iou": _iou(rng, B, S)}
    new, um = _cand(rng, G, True), _cand(rng, ND, False)
    # the first unmatched detection is never a candidate: a live track
    # that no detection overlaps points its argmax there in both packages
    um["mask"][:, 0] = False
    return st, new, um


def _run(seed, tp, fp):
    st, new, um = _inputs(seed)
    jst = JaxTrackState.empty(B, S, C, 1).replace(
        **{k: jnp.asarray(v) for k, v in st.items()})
    pst = TrackState.empty(B, S, C, 1).replace(
        **{k: torch.from_numpy(v) for k, v in st.items()})
    jout = jax_select(jst, {k: jnp.asarray(v) for k, v in new.items()},
                      {k: jnp.asarray(v) for k, v in um.items()},
                      jax.random.PRNGKey(0), 0.5, tp, fp)
    pout = select_active_tracks_train(
        pst, {k: torch.from_numpy(v) for k, v in new.items()},
        {k: torch.from_numpy(v) for k, v in um.items()},
        torch.Generator().manual_seed(0), 0.5, tp, fp)
    return jout, pout


@pytest.mark.parametrize("tp,fp", [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0),
                                   (1.0, 1.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_selection_matches_jax(seed, tp, fp):
    jout, pout = _run(seed, tp, fp)
    fake = ~np.asarray(jout.mask).any(1) | (np.asarray(jout.ids) == -2).any(1)
    np.testing.assert_array_equal(pout.mask.numpy(), np.asarray(jout.mask))
    np.testing.assert_array_equal(pout.ids.numpy(), np.asarray(jout.ids))
    for f in SLOT_FIELDS:
        got, want = getattr(pout, f).numpy(), np.asarray(getattr(jout, f))
        # rows with the fake track: slot 0 holds random draws
        got, want = got[~fake], want[~fake]
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, err_msg=f)


def test_selection_paths_are_exercised():
    """Default: a low-IoU track loses its identity but stays; TP-drop 1.0
    empties every row (the fallback fires); FP-insert 1.0 adds unmatched
    detections."""
    st, new, um = _inputs(0)
    _, default = _run(0, 0.0, 0.0)
    low = st["mask"] & (st["iou"] < 0.5) & (st["ids"] >= 0)
    assert low.any()
    assert (default.ids.numpy()[low] == -1).all()
    _, dropped = _run(0, 1.0, 0.0)
    assert (dropped.ids.numpy()[:, 0] == -2).all()
    assert dropped.mask.numpy().sum() == B
    _, inserted = _run(0, 0.0, 1.0)
    assert (inserted.ids.numpy()[inserted.mask.numpy()] == -1).any()
