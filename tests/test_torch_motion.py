"""Post-hoc motion (``USE_MOTION``) against the JAX package.

``Motion`` / ``MotionBank`` on ``tests/test_motion.py``'s cases, each
against ``memotr_tpu.models.motion`` on the same inputs; then the port's
``Submitter._apply_motion`` against JAX's on one sequence of hand-built
track states: a track seen for 4 frames, missing for 2 (its reference
points moved), seen again for 2 (its record restarts), then missing with a
record too short to move it; a track that goes missing with a short record;
a track seen throughout; an empty slot.  ``ref_pts`` agree to 1e-6.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memotr_tpu.engine.submit import Submitter as JaxSubmitter
from memotr_tpu.models import motion as jax_motion
from memotr_tpu.structures.track_state import TrackState as JaxTrackState
from memotr_tpu_torch.engine.submit import Submitter
from memotr_tpu_torch.models import motion
from memotr_tpu_torch.structures.track_state import TrackState
from test_torch_port_weights import TINY_CFG

BOXES = {
    "mean_delta": [[10 + 2 * t, 5 + t, 4, 4] for t in range(4)],
    "ring_buffer": [[40.0, 0, 1, 1]] * 5 + [[40.0 + 2 * t, 0, 1, 1]
                                            for t in range(1, 4)],
    "single_box": [[1, 1, 1, 1]],
    "no_box": [],
}


@pytest.mark.parametrize("case", sorted(BOXES))
def test_motion_record_matches_jax(case):
    got, want = motion.Motion(3, 5), jax_motion.Motion(3, 5)
    for box in BOXES[case]:
        got.add_box(np.asarray(box, np.float32))
        want.add_box(np.asarray(box, np.float32))
    assert len(got) == len(want)
    for miss in (1, 2, 3):
        np.testing.assert_array_equal(got.get_box_delta(miss),
                                      want.get_box_delta(miss))


def _bank_calls(bank):
    """tests/test_motion.py's bank cases: the minimum-length gate, lambda,
    an unknown id, and the reset on reappearance."""
    out = []
    bank.observe(7, np.array([0.0, 0, 1, 1], np.float32), reappeared=False)
    bank.observe(7, np.array([1.0, 0, 1, 1], np.float32), reappeared=False)
    out.append(bank.extrapolate(7, np.array([1.0, 0, 1, 1]), 1, 0.5))
    bank.observe(7, np.array([2.0, 0, 1, 1], np.float32), reappeared=False)
    out.append(bank.extrapolate(7, np.array([2.0, 0, 1, 1], np.float32),
                                miss_length=2, lam=0.5))
    out.append(bank.extrapolate(99, np.zeros(4), 1, 0.5))
    for t in range(4):
        bank.observe(1, np.array([float(t), 0, 1, 1], np.float32),
                     reappeared=False)
    out.append(bank.extrapolate(1, np.zeros(4), 3, 0.5))
    bank.observe(1, np.array([9.0, 0, 1, 1], np.float32), reappeared=True)
    out.append(len(bank.records[1]))
    out.append(bank.extrapolate(1, np.zeros(4), 1, 0.5))
    return out


def test_motion_bank_matches_jax():
    got = _bank_calls(motion.MotionBank(3, 5))
    want = _bank_calls(jax_motion.MotionBank(3, 5))
    assert [g is None for g in got] == [w is None for w in want]
    for g, w in zip(got, want):
        if g is not None:
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], [3.0, 0, 1, 1])


SLOTS, HD = 4, 8


def _frames():
    """Per frame: (mask, ids, boxes, last_appear_boxes, disappear_time,
    ref_pts) of one lane.  Slot 0: track 7, seen in frames 0-3, missing in
    4-5, seen in 6-7, missing in 8; slot 1: track 3, seen in 0-1, missing
    in 2-4, then freed; slot 2: track 9, seen throughout; slot 3 empty."""
    rng = np.random.default_rng(0)
    box7 = lambda t: [0.30 + 0.02 * t, 0.40 - 0.01 * t, 0.10, 0.20]  # noqa: E731
    out = []
    last = {0: box7(0), 1: [0.6, 0.6, 0.1, 0.1]}
    for t in range(9):
        mask = np.asarray([True, t < 5, True, False])
        ids = np.asarray([7, 3 if t < 5 else -1, 9, -1], np.int32)
        boxes = rng.uniform(0.2, 0.8, (SLOTS, 4)).astype(np.float32)
        dis = np.zeros(SLOTS, np.int32)
        missing0 = {4: 1, 5: 2, 8: 1}.get(t, 0)
        if missing0:
            dis[0] = missing0
        else:
            boxes[0] = box7(t)
            last[0] = box7(t)
        if 2 <= t < 5:
            dis[1] = t - 1
        elif t < 2:
            boxes[1] = [0.6 + 0.03 * t, 0.6, 0.1, 0.1]
            last[1] = boxes[1].tolist()
        la = rng.uniform(0.2, 0.8, (SLOTS, 4)).astype(np.float32)
        la[0], la[1] = last[0], last[1]
        ref = rng.normal(size=(SLOTS, 4)).astype(np.float32)
        out.append((mask, ids, boxes, la, dis, ref))
    return out


def test_apply_motion_matches_jax(tmp_path):
    cfg = dict(TINY_CFG, USE_MOTION=True, MOTION_LAMBDA=0.5,
               MOTION_MIN_LENGTH=3, MOTION_MAX_LENGTH=5, EVAL_CACHE=False)
    port = Submitter("DanceTrack", [], "seq", str(tmp_path), None, cfg,
                     "cpu")
    ref = SimpleNamespace(motion_bank=jax_motion.MotionBank(3, 5),
                          motion_lambda=0.5)
    moved = []
    for mask, ids, boxes, la, dis, ref_pts in _frames():
        fields = dict(mask=mask, ids=ids, boxes=boxes, last_appear_boxes=la,
                      disappear_time=dis, ref_pts=ref_pts)
        st = TrackState.empty(1, SLOTS, HD, 1).replace(
            **{k: torch.from_numpy(v)[None] for k, v in fields.items()})
        jst = JaxTrackState.empty(1, SLOTS, HD, 1).replace(
            **{k: jnp.asarray(v)[None] for k, v in fields.items()})
        got = port._apply_motion(st).ref_pts[0].numpy()
        want = np.asarray(JaxSubmitter._apply_motion(ref, jst).ref_pts[0])
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        moved.append([bool(np.any(got[s] != ref_pts[s]))
                      for s in range(SLOTS)])
    # only track 7 in its two missing frames after a 4-frame record
    assert [t for t, m in enumerate(moved) if any(m)] == [4, 5]
    assert all(m == [True, False, False, False] for m in moved[4:6])
