"""The port's streaming submit engine against the JAX package's (float32,
CPU), on the tiny deformable MeMOTR of the parity tests.

A 6-frame sequence is written as PNG (lossless, so both packages decode
the same pixels): 64x96 frames of a noisy background with a textured block
that is in frames 1-2, leaves in frames 3-4 and returns in 5-6, on the
64x128 canvas (32 padded columns).  JAX's pipelined ``Submitter`` and the
port's ``Submitter``, with the weights of one seeded JAX tree on both sides
(``state_dict_from_jax``) and the eval cache on, write MOT txt:

- the port's pipelined and sync loops write byte-identical files;
- against JAX's: the same lines, frame, id and the class columns equal,
  box coordinates within 1e-2 px.

Also: ``BatchedSubmitter`` lanes of unequal length through ``submit()``
(``SUBMIT_BATCH`` 2, sequences grouped by canvas, a portrait sequence in a
group of its own) equal their B=1 runs; ``USE_MOTION`` takes the sync
loop; a frame iterator and a writer that raise make ``run()`` raise within
seconds; ``VISUALIZE`` takes the sync loop and the batched loop refuses it.  The JAX eval step compiles once, in a
module-scoped fixture; ``test_torch_submit_windowed.py`` does the same for
the windowed model with these helpers.
"""
import os
import threading

import cv2
import numpy as np
import pytest
import torch
import yaml

from memotr_tpu.engine.submit import Submitter as JaxSubmitter
from memotr_tpu.models.memotr import build_model as jax_build_model
from memotr_tpu.models.query_updater import build_query_updater
from memotr_tpu_torch.data.seq_dataset import SeqDataset
from memotr_tpu_torch.engine.submit import (BatchedSubmitter, Submitter,
                                            submit)
from test_torch_port_weights import TINY_CFG
from test_torch_windowed_slice import jax_trees, port_model

FRAME_HW = (64, 96)
CANVAS = (64, 128)
N_FRAMES = 6
CFG = dict(TINY_CFG, MISS_TOLERANCE=2, EVAL_SHORT_SIDE=CANVAS[0],
           EVAL_MAX_SIDE=CANVAS[1])
BOX_PX = 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models in one torch thread: the suite runs six workers on the
    machine's cores, and torch's default of one thread per core in each of
    them slows every parallel region by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_sequence(root, name, n_frames=N_FRAMES, seed=0, portrait=False):
    """A DanceTrack-layout PNG sequence; the block is absent from frames
    3 and 4 (1-based).  Returns the sequence directory."""
    rng = np.random.default_rng(seed)
    h, w = FRAME_HW[::-1] if portrait else FRAME_HW
    img_dir = os.path.join(root, name, "img1")
    os.makedirs(img_dir)
    bg = rng.integers(30, 130, (h, w, 3), np.uint8)
    tex = rng.integers(120, 255, (20, 16, 3), np.uint8)
    for t in range(n_frames):
        img = bg.copy()
        if t not in (2, 3):
            x = 10 + 7 * (t % 6)
            img[18:38, x:x + 16] = tex
        cv2.imwrite(os.path.join(img_dir, f"{t + 1:08d}.png"),
                    img[:, :, ::-1])                       # RGB -> BGR
    return os.path.join(root, name)


def seq_frames(seq_dir):
    ds = SeqDataset(seq_dir, CFG["EVAL_SHORT_SIDE"], CFG["EVAL_MAX_SIDE"])
    return [ds[i] for i in range(len(ds))]


def jax_submit(cfg, trees, seq_dir, out_dir):
    """JAX's default (pipelined) Submitter; returns its txt."""
    params, uparams, frozen = trees
    sub = JaxSubmitter("DanceTrack", seq_dir, "seq", out_dir,
                       jax_build_model(cfg), build_query_updater(cfg),
                       {"params": params, "frozen": frozen},
                       {"params": uparams}, cfg)
    assert sub.pipelined
    sub.run()
    return read(os.path.join(out_dir, "tracker", "seq.txt"))


def port_submit(cfg, model, seq_dir, out_dir, pipelined=True):
    sub = Submitter("DanceTrack", iter(seq_frames(seq_dir)), "seq", out_dir,
                    model, cfg, "cpu")
    assert sub.pipelined
    sub.pipelined = pipelined
    sub.run()
    assert len(sub.frame_seconds) == N_FRAMES
    return read(os.path.join(out_dir, "tracker", "seq.txt"))


def read(path):
    with open(path) as f:
        return f.read()


def assert_same_tracks(got: str, want: str):
    """Frame, id and the constant columns equal; boxes within BOX_PX."""
    got, want = got.splitlines(), want.splitlines()
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(got, want):
        a, b = a.split(","), b.split(",")
        assert a[:2] == b[:2] and a[6:] == b[6:], (a, b)
        np.testing.assert_allclose(np.float64(a[2:6]), np.float64(b[2:6]),
                                   atol=BOX_PX)


def streams(cfg, seed, tmp):
    """The JAX txt and the port's pipelined and sync txt of one sequence."""
    trees = jax_trees(cfg, seed)
    seq_dir = write_sequence(str(tmp / "data"), "seq")
    model = port_model(cfg, trees)
    return {"jax": jax_submit(cfg, trees, seq_dir, str(tmp / "jax")),
            "pipelined": port_submit(cfg, model, seq_dir, str(tmp / "p")),
            "sync": port_submit(cfg, model, seq_dir, str(tmp / "s"),
                                pipelined=False)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return streams(CFG, 21, tmp_path_factory.mktemp("submit"))


def test_sequence_is_tracked(runs):
    lines = runs["jax"].splitlines()
    assert lines
    ids = {ln.split(",")[1] for ln in lines}
    frames = {int(ln.split(",")[0]) for ln in lines}
    assert len(ids) > 1 and frames == set(range(1, N_FRAMES + 1))


def test_pipelined_equals_sync_bytes(runs):
    assert runs["pipelined"] == runs["sync"]


def test_port_submitter_matches_jax(runs):
    assert_same_tracks(runs["pipelined"], runs["jax"])


@pytest.fixture(scope="module")
def model():
    return port_model(CFG, jax_trees(CFG, 21))


def _submit_dir(tmp, model, seqs):
    """SUBMIT_DIR with the train config and the model's .pth, and a split
    of PNG sequences: name -> (frames, seed, portrait)."""
    torch.save({"model": model.state_dict()}, tmp / "model.pth")
    os.makedirs(tmp / "train")
    with open(tmp / "train" / "config.yaml", "w") as f:
        yaml.dump(CFG, f)
    split = tmp / "data" / "DanceTrack" / "val"
    for name, (n, seed, portrait) in seqs.items():
        write_sequence(str(split), name, n, seed, portrait)
    return {"SUBMIT_DIR": str(tmp), "SUBMIT_MODEL": "model.pth",
            "SUBMIT_DATA_SPLIT": "val", "DATA_ROOT": str(tmp / "data"),
            **CFG}


def _parse(path):
    rows = []
    for line in read(path).splitlines():
        p = line.split(",")
        rows.append((int(p[0]), int(p[1])) + tuple(float(v) for v in p[2:6]))
    return rows


def test_batched_lanes_equal_their_b1_runs(model, tmp_path):
    """``submit()`` at SUBMIT_BATCH 2 (lanes of 4 and 2 frames in one
    BatchedSubmitter, the portrait sequence alone) against SUBMIT_BATCH 1:
    each lane's ids equal, boxes within 1e-2 px, no frame past a lane's
    end."""
    seqs = {"seq_a": (4, 1, False), "seq_b": (2, 2, False),
            "seq_c": (2, 3, True)}
    config = _submit_dir(tmp_path, model, seqs)
    runs_dir = {}
    for batch in (1, 2):
        out = tmp_path / f"b{batch}"
        submit(dict(config, SUBMIT_BATCH=batch), "cpu")
        os.rename(tmp_path / "val", out)
        runs_dir[batch] = out / "tracker"
    for name, (n, _, _) in seqs.items():
        ref = _parse(runs_dir[1] / f"{name}.txt")
        got = _parse(runs_dir[2] / f"{name}.txt")
        assert ref and len(ref) == len(got), (name, len(ref), len(got))
        for r, g in zip(ref, got):
            assert r[:2] == g[:2], (name, r, g)
            np.testing.assert_allclose(r[2:], g[2:], atol=BOX_PX,
                                       err_msg=name)
        assert max(r[0] for r in got) <= n


def test_batched_lanes_must_share_a_canvas(model, tmp_path):
    wide = seq_frames(write_sequence(str(tmp_path), "a", 2))
    tall = seq_frames(write_sequence(str(tmp_path), "b", 2, portrait=True))
    with pytest.raises(AssertionError, match="share a canvas"):
        BatchedSubmitter("DanceTrack", [wide, tall], ["a", "b"],
                         str(tmp_path / "out"), model, CFG, "cpu")


def test_motion_takes_the_sync_loop(model, tmp_path):
    frames = seq_frames(write_sequence(str(tmp_path), "seq", 3))
    sub = Submitter("DanceTrack", iter(frames), "seq", str(tmp_path / "o"),
                    model, dict(CFG, USE_MOTION=True), "cpu")
    assert not sub.pipelined
    sub.run()
    assert len(sub.frame_seconds) == 3
    assert sub.motion_bank.records


def _finishes(run, timeout=60.0):
    """Runs ``run`` in a thread; returns its exception (it must end)."""
    got = {}

    def target():
        try:
            run()
        except BaseException as e:  # noqa: BLE001 - returned
            got["err"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "run() hung"
    return got.get("err")


@pytest.mark.parametrize("pipelined", [True, False])
def test_failing_frame_iterator_raises(model, tmp_path, pipelined):
    frames = seq_frames(write_sequence(str(tmp_path), "seq", 3))

    def broken():
        yield from frames[:2]
        raise OSError("frame 3 unreadable")

    sub = Submitter("DanceTrack", broken(), "seq", str(tmp_path / "o"),
                    model, CFG, "cpu")
    sub.pipelined = pipelined
    err = _finishes(sub.run)
    assert isinstance(err, OSError) and "unreadable" in str(err)


def test_failing_writer_raises(model, tmp_path):
    """A writer thread that dies must abort the run, not leave the
    dispatch loop waiting on a full results queue (more frames than the
    queue holds)."""
    frames = seq_frames(write_sequence(str(tmp_path), "seq", 12))
    sub = Submitter("DanceTrack", iter(frames), "seq", str(tmp_path / "o"),
                    model, CFG, "cpu")

    def boom(*args):
        raise RuntimeError("writer boom")

    sub._write_frame = boom
    err = _finishes(sub.run)
    assert isinstance(err, RuntimeError) and "writer boom" in str(err)


def test_visualize_is_refused(model, tmp_path):
    """``VISUALIZE`` (debug dumps, ``tests/test_torch_debug_dump.py``)
    needs each frame's state on the host: the Submitter takes the sync
    loop and the batched loop refuses it, as JAX's submit does."""
    cfg = dict(CFG, VISUALIZE=True)
    sub = Submitter("DanceTrack", [], "seq", str(tmp_path), model, cfg,
                    "cpu")
    assert not sub.pipelined
    with pytest.raises(ValueError, match="VISUALIZE"):
        BatchedSubmitter("DanceTrack", [[]], ["seq"], str(tmp_path), model,
                         cfg, "cpu")


def test_pipelined_loop_keeps_order_under_thread_switching():
    """The three threads of ``stream_pipelined`` with a switch interval of
    1 us: every batch is written once, in order, with its own result."""
    import sys

    from memotr_tpu_torch.engine.submit import stream_pipelined
    n = 300
    seen = []

    def batches():
        for i in range(n):
            yield np.full((1, 2, 2, 3), i % 251, np.uint8), \
                np.zeros((1, 2, 2), bool), i

    def step(images, masks, host_masks):
        return torch.full((1, 3, 9), float(images[0, 0, 0, 0]))

    def write(i, arr, meta):
        seen.append((i, meta, int(arr[0, 0, 0])))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        done = stream_pipelined(batches(), step, write, torch.device("cpu"))
    finally:
        sys.setswitchinterval(interval)
    assert seen == [(i, i, i % 251) for i in range(n)]
    assert len(done) == n and done == sorted(done)
