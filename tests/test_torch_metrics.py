"""The port's tracking metrics (``memotr_tpu_torch/metrics``) against the
JAX package's (``memotr_tpu/metrics``), at float64 on the CPU.

Seeded synthetic scenarios (GT tracks moving at constant speed; a tracker
with drops, id switches, jitter and false positives: ``synth_scenario``,
this file's own copy of tests/test_metrics.py's, which skips at import
where TrackEval is absent) go through both packages:

- HOTA, CLEAR, Identity, VACE, IDEucl and Count, per sequence and
  combined over three sequences, and TrackMAP per sequence, combined and
  summarized: every number agrees to 1e-12 (both are numpy in one order,
  so they agree exactly where the copy is faithful);
- the per-frame similarity data;
- the MOT17 distractor step (tracker boxes matched to distractor GTs
  dropped, invalid and non-pedestrian GTs dropped), ``load_seqmap``, a
  seqmap's subset, a perfect tracker reading 100, ``write_summary`` byte
  for byte, and ``evaluate_sequences`` in a pool of 2 giving the dict of
  1 (and of JAX's).
"""
import os

import numpy as np
import pytest

from memotr_tpu.metrics import clear as jax_clear
from memotr_tpu.metrics import count as jax_count
from memotr_tpu.metrics import evaluator as jax_evaluator
from memotr_tpu.metrics import hota as jax_hota
from memotr_tpu.metrics import identity as jax_identity
from memotr_tpu.metrics import ideucl as jax_ideucl
from memotr_tpu.metrics import similarity as jax_similarity
from memotr_tpu.metrics import track_map as jax_track_map
from memotr_tpu.metrics import vace as jax_vace
from memotr_tpu_torch.metrics import clear, count, evaluator, hota, identity
from memotr_tpu_torch.metrics import ideucl, similarity, track_map, vace

ATOL = 1e-12
# name: (port module, JAX module, per-sequence function, combine function)
METRICS = {
    "hota": (hota, jax_hota, "hota_sequence", "combine_hota"),
    "clear": (clear, jax_clear, "clear_sequence", "combine_clear"),
    "identity": (identity, jax_identity, "identity_sequence",
                 "combine_identity"),
    "vace": (vace, jax_vace, "vace_sequence", "combine_vace"),
    "ideucl": (ideucl, jax_ideucl, "ideucl_sequence", "combine_ideucl"),
    "count": (count, jax_count, "count_sequence", "combine_count"),
}


def synth_scenario(rng, n_frames=30, n_gt=6, drop_p=0.2, noise=5.0,
                   id_switch_p=0.05, fp_p=0.1):
    """Random GT tracks + noisy tracker with drops, switches and FPs."""
    gt_frames, pr_frames = [], []
    base = rng.uniform(50, 400, (n_gt, 2))
    vel = rng.uniform(-3, 3, (n_gt, 2))
    wh = rng.uniform(20, 60, (n_gt, 2))
    id_map = np.arange(n_gt)
    for t in range(n_frames):
        pos = base + vel * t
        gids, gboxes, pids, pboxes = [], [], [], []
        for g in range(n_gt):
            gids.append(g)
            gboxes.append([pos[g, 0], pos[g, 1], wh[g, 0], wh[g, 1]])
            if rng.random() > drop_p:
                if rng.random() < id_switch_p:
                    id_map[g] = 100 + rng.integers(0, 50)
                pids.append(int(id_map[g]))
                jitter = rng.normal(0, noise, 2)
                pboxes.append([pos[g, 0] + jitter[0], pos[g, 1] + jitter[1],
                               wh[g, 0], wh[g, 1]])
        for _ in range(rng.poisson(fp_p * n_gt)):
            pids.append(int(1000 + rng.integers(0, 30)))
            xy = rng.uniform(0, 500, 2)
            pboxes.append([xy[0], xy[1], 30, 40])
        gt_frames.append((np.asarray(gids), np.asarray(gboxes, np.float64)))
        pr_frames.append((np.asarray(pids, np.int64),
                          np.asarray(pboxes, np.float64).reshape(-1, 4)))
    return gt_frames, pr_frames


def assert_same(got, want, path="result"):
    """Equal structure; every number within ATOL (NaN where NaN)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, set(got) ^ set(want))
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        w = np.asarray(want, np.float64)
        g = np.asarray(got, np.float64)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=path)


def scenarios(seed, n=3):
    rng = np.random.default_rng(seed)
    return [synth_scenario(rng) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_sequence_data_matches_jax(seed):
    for gt, pr in scenarios(seed):
        assert_same(similarity.build_sequence_data(gt, pr),
                    jax_similarity.build_sequence_data(gt, pr))
        assert_same(similarity.iou_xywh(gt[0][1], pr[0][1]),
                    jax_similarity.iou_xywh(gt[0][1], pr[0][1]))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax(name, seed):
    """Per sequence and combined over the three sequences."""
    port_mod, jax_mod, seq_fn, comb_fn = METRICS[name]
    datas = [jax_similarity.build_sequence_data(gt, pr)
             for gt, pr in scenarios(seed)]
    got = [getattr(port_mod, seq_fn)(d) for d in datas]
    want = [getattr(jax_mod, seq_fn)(d) for d in datas]
    assert_same(got, want, seq_fn)
    assert_same(getattr(port_mod, comb_fn)(got),
                getattr(jax_mod, comb_fn)(want), comb_fn)
    if name == "hota":
        assert_same(hota.summarize(hota.combine_hota(got)),
                    jax_hota.summarize(jax_hota.combine_hota(want)))


def test_scenarios_exercise_the_metrics():
    """The scenarios hold misses, false positives and id switches."""
    datas = [jax_similarity.build_sequence_data(gt, pr)
             for gt, pr in scenarios(0)]
    c = clear.combine_clear([clear.clear_sequence(d) for d in datas])
    assert c["CLR_FN"] > 0 and c["CLR_FP"] > 0 and c["IDSW"] > 0
    assert 0 < c["MOTA"] < 1


@pytest.mark.parametrize("seed", [21, 22])
def test_track_map_matches_jax(seed):
    rng = np.random.default_rng(seed)
    got, want = [], []
    for _ in range(3):
        gt_frames, pr_frames = synth_scenario(rng, n_frames=12, n_gt=5)
        pr_scores = [rng.uniform(0.3, 1.0, len(ids)) for ids, _ in pr_frames]
        data = track_map.build_track_data(gt_frames, pr_frames, pr_scores)
        assert_same(data, jax_track_map.build_track_data(
            gt_frames, pr_frames, pr_scores))
        got.append(track_map.track_map_sequence(data))
        want.append(jax_track_map.track_map_sequence(data))
    assert_same(got, want)
    comb = track_map.combine_track_map(got)
    assert_same(comb, jax_track_map.combine_track_map(want))
    assert_same(track_map.summarize(comb),
                jax_track_map.summarize(jax_track_map.combine_track_map(want)))


def test_package_exports_match_jax():
    import memotr_tpu.metrics as jax_metrics
    import memotr_tpu_torch.metrics as port_metrics
    names = {n for n in dir(jax_metrics) if not n.startswith("_")}
    assert names <= set(dir(port_metrics)), names - set(dir(port_metrics))


def _write_mot(path, frames, with_class=True):
    """frames: {t: [(id, x, y, w, h, conf, cls, vis)]} -> MOT txt."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for t in sorted(frames):
            for i, x, y, w, h, conf, cls, vis in frames[t]:
                tail = f",{conf},{cls},{vis}" if with_class else ",1,-1,-1,-1"
                f.write(f"{t},{i},{x},{y},{w},{h}{tail}\n")


def _mot17_case(root, seed):
    """A MOT17-style GT with distractor classes (2, 7, 8, 12), a class-3
    (non-pedestrian) box and conf-0 rows, and a tracker whose boxes sit on
    pedestrians and on distractors (with jitter) plus a few strays."""
    rng = np.random.default_rng(seed)
    gt, pr = {}, {}
    classes = [1, 1, 1, 2, 7, 8, 12, 3, 1]
    confs = [1, 1, 1, 1, 1, 1, 1, 1, 0]
    base = rng.uniform(20, 400, (len(classes), 2))
    for t in range(1, 9):
        gt[t], pr[t] = [], []
        for g, (cls, conf) in enumerate(zip(classes, confs)):
            x, y = base[g] + 4 * t
            gt[t].append((g + 1, x, y, 40, 80, conf, cls, 1.0))
            if rng.random() < 0.85:
                jx, jy = rng.normal(0, 2, 2)
                pr[t].append((50 + g, x + jx, y + jy, 40, 80, 1, -1, -1))
        if rng.random() < 0.5:
            pr[t].append((99, *rng.uniform(0, 500, 2), 30, 30, 1, -1, -1))
    gt_path = os.path.join(root, "gt", "MOT17-02", "gt", "gt.txt")
    pr_path = os.path.join(root, "tracker", "MOT17-02.txt")
    _write_mot(gt_path, gt)
    _write_mot(pr_path, pr, with_class=False)
    return gt_path, pr_path


def test_mot17_preprocessing_matches_jax(tmp_path):
    gt_path, pr_path = _mot17_case(str(tmp_path), seed=5)
    gt = evaluator.load_mot_file(gt_path)
    pr = evaluator.load_mot_file(pr_path)
    assert_same(dict(gt), dict(jax_evaluator.load_mot_file(gt_path)))
    assert_same(dict(pr), dict(jax_evaluator.load_mot_file(pr_path)))
    distr = evaluator.MOT17_DISTRACTORS
    got = evaluator.preprocess_sequence(gt, pr, distr, True)
    want = jax_evaluator.preprocess_sequence(gt, pr, distr, True)
    assert_same(got, want)
    gt_out, pr_out = got
    # the step did its work: distractor-matched boxes and non-pedestrian
    # or invalid GTs are gone
    n_pr = sum(len(v) for v in pr.values())
    assert sum(len(ids) for ids, _ in pr_out) < n_pr
    assert all(set(ids.tolist()) <= {1, 2, 3} for ids, _ in gt_out)
    assert set(np.concatenate([ids for ids, _ in pr_out]).tolist()) \
        .isdisjoint({53, 54, 55, 56})
    assert_same(evaluator.evaluate_one_sequence((gt_path, pr_path, distr,
                                                 True)),
                jax_evaluator.evaluate_one_sequence((gt_path, pr_path, distr,
                                                     True)))
    port = evaluator.evaluate_mot_challenge(
        str(tmp_path / "gt"), str(tmp_path / "tracker"), dataset="MOT17",
        num_parallel=1)
    assert_same(port, jax_evaluator.evaluate_mot_challenge(
        str(tmp_path / "gt"), str(tmp_path / "tracker"), dataset="MOT17",
        num_parallel=1))


def _dancetrack_case(root, n_seqs=3):
    """``n_seqs`` GT sequences and tracker files from seeded scenarios."""
    gt_dir, tr_dir = os.path.join(root, "gt"), os.path.join(root, "tracker")
    for s, (gt, pr) in enumerate(scenarios(40, n_seqs)):
        for frames, path in (
                (gt, os.path.join(gt_dir, f"seq{s}", "gt", "gt.txt")),
                (pr, os.path.join(tr_dir, f"seq{s}.txt"))):
            rows = {t + 1: [(int(i) + 1, *b, 1, 1, 1.0)
                            for i, b in zip(ids, boxes)]
                    for t, (ids, boxes) in enumerate(frames)}
            _write_mot(path, rows)
    return gt_dir, tr_dir


def test_evaluate_sequences_pool_of_two_equals_one(tmp_path):
    gt_dir, tr_dir = _dancetrack_case(str(tmp_path))
    pairs = [(os.path.join(gt_dir, f"seq{s}", "gt", "gt.txt"),
              os.path.join(tr_dir, f"seq{s}.txt")) for s in range(3)]
    one = evaluator.evaluate_sequences(pairs, num_parallel=1)
    two = evaluator.evaluate_sequences(pairs, num_parallel=2)
    assert one == two
    assert_same(one, jax_evaluator.evaluate_sequences(pairs, num_parallel=1))
    assert 0 < one["HOTA"] < 100 and one["IDSW"] > 0


def test_seqmap_selects_a_subset(tmp_path):
    gt_dir, tr_dir = _dancetrack_case(str(tmp_path))
    smap = tmp_path / "val_seqmap.txt"
    smap.write_text("name\nseq2\nseq0\n")
    assert evaluator.load_seqmap(str(smap)) == ["seq2", "seq0"]
    assert evaluator.load_seqmap(str(smap)) == \
        jax_evaluator.load_seqmap(str(smap))
    sub = evaluator.evaluate_mot_challenge(gt_dir, tr_dir, num_parallel=1,
                                           seqmap_file=str(smap))
    assert_same(sub, jax_evaluator.evaluate_mot_challenge(
        gt_dir, tr_dir, num_parallel=1, seqmap_file=str(smap)))
    assert_same(sub, evaluator.evaluate_mot_challenge(
        gt_dir, tr_dir, seq_names=["seq2", "seq0"], num_parallel=1))
    every = evaluator.evaluate_mot_challenge(gt_dir, tr_dir, num_parallel=1)
    assert sub["GT_Dets"] < every["GT_Dets"]


def test_perfect_tracker_reads_100(tmp_path):
    gt_dir, _ = _dancetrack_case(str(tmp_path))
    tr_dir = tmp_path / "perfect"
    tr_dir.mkdir()
    for s in range(3):
        with open(os.path.join(gt_dir, f"seq{s}", "gt", "gt.txt")) as f:
            (tr_dir / f"seq{s}.txt").write_text(f.read())
    m = evaluator.evaluate_mot_challenge(gt_dir, str(tr_dir), num_parallel=1)
    for k in ("HOTA", "DetA", "AssA", "MOTA", "IDF1"):
        assert m[k] == pytest.approx(100.0, abs=1e-9), k
    assert m["IDSW"] == 0 and m["CLR_FP"] == 0 and m["CLR_FN"] == 0


def test_write_summary_is_byte_identical(tmp_path):
    gt_dir, tr_dir = _dancetrack_case(str(tmp_path))
    m = evaluator.evaluate_mot_challenge(gt_dir, tr_dir, num_parallel=1)
    evaluator.write_summary(m, str(tmp_path / "port" / "summary.txt"))
    jax_evaluator.write_summary(m, str(tmp_path / "jax" / "summary.txt"))
    got = (tmp_path / "port" / "summary.txt").read_bytes()
    assert got == (tmp_path / "jax" / "summary.txt").read_bytes()
    head, values = got.decode().splitlines()
    assert head.split()[:3] == ["HOTA", "DetA", "AssA"]
    assert len(head.split()) == len(values.split()) == len(m)
