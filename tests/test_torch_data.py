"""The port's data slice against the JAX package's (CPU, no JAX compile).

Synthetic trees of each dataset (DanceTrack, SportsMOT, MOT17 with
CrowdHuman and MOTSynth, BDD100K) as ``tests/test_data.py`` builds them,
small JPEGs.  Compared under the same ``random.seed`` / ``np.random.seed``:
the GT tables, id offsets and the curriculum over 3 epochs; every
transform alone and the training stacks whole (images to 1e-6, boxes to
1e-5, ids and labels exact: the same draws in the same order give the same
float32 arithmetic); the port's threaded ``DataLoader`` against JAX's at 1
worker (every batch and ``gt_dropped`` equal, both ranks of a world of 2,
on a fixed canvas) and at 3 (the batch order).
"""
import os
import random
import threading

import numpy as np
import PIL.Image
import pytest

import memotr_tpu.data as jax_data
import memotr_tpu.data.transforms as jt
import memotr_tpu_torch.data as port_data
import memotr_tpu_torch.data.transforms as pt
from memotr_tpu_torch.data.loader import DataLoader
from memotr_tpu.data.loader import DataLoader as JaxDataLoader

H, W = 54, 96


def _jpg(path, rng, hw=(H, W)):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    PIL.Image.fromarray(rng.integers(0, 255, hw + (3,), np.uint8)).save(path)


def _rows(t, n, big=False):
    """n boxes drifting with t; one of them large, so crops drop others."""
    return [(o + 1, 6 + 9 * o + t, 4 + 4 * o, 30 if big and o == 0 else 12,
             14) for o in range(n)]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for name, digits in (("DanceTrack", 8), ("SportsMOT", 6)):
        for vid in ("v1", "v2"):
            vdir = root / name / "train" / vid
            lines = []
            for t in range(1, 8):
                _jpg(str(vdir / "img1" / f"{t:0{digits}d}.jpg"), rng)
                lines += [f"{t},{i},{x},{y},{w},{h},1,1,1\n"
                          for i, x, y, w, h in _rows(t, 3, big=True)]
            os.makedirs(vdir / "gt")
            (vdir / "gt" / "gt.txt").write_text("".join(lines))
    for seq in ("MOT17-02-SDP", "MOT17-02-FRCNN"):
        for t in range(1, 6):
            _jpg(str(root / "MOT17" / "images" / "train" / seq / "img1"
                     / f"{t:06d}.jpg"), rng)
            gdir = root / "MOT17" / "gts" / "train" / seq / "img1"
            os.makedirs(gdir, exist_ok=True)
            (gdir / f"{t:06d}.txt").write_text("".join(
                f"0 {i} {x} {y} {w} {h} 0.5\n" for i, x, y, w, h in _rows(t, 3)))
    for name in ("ch_a", "ch_b"):
        _jpg(str(root / "CrowdHuman" / "images" / "val" / f"{name}.jpg"), rng)
        gdir = root / "CrowdHuman" / "gts" / "val"
        os.makedirs(gdir, exist_ok=True)
        (gdir / f"{name}.txt").write_text("".join(
            f"0 {i} {x} {y} {w} {h}\n" for i, x, y, w, h in _rows(2, 2)))
    for t in range(1, 9):
        _jpg(str(root / "MOTSynth" / "frames" / "s1" / "rgb" / f"{t:04d}.jpg"),
             rng)
    gdir = root / "MOTSynth" / "gts" / "s1" / "gt"
    os.makedirs(gdir)
    (gdir / "gt.txt").write_text("".join(
        f"{t},{i},{x},{y},{w},{h},1,1,{0.0 if i == 2 and t == 3 else 1.0}\n"
        for t in range(1, 9) for i, x, y, w, h in _rows(t, 2)))
    for vid in ("b1", "b2"):
        for t in range(1, 7):
            _jpg(str(root / "BDD100K" / "images" / "track" / "train" / vid
                     / f"{vid}-{t:07d}.jpg"), rng)
            if vid == "b2" and t == 4:          # a frame without a GT file
                continue
            gdir = root / "BDD100K" / "filter_labels" / "track" / "train" / vid
            os.makedirs(gdir, exist_ok=True)
            rows = [] if t == 2 else _rows(t, 3)     # an empty GT file
            (gdir / f"{vid}-{t:07d}.txt").write_text("".join(
                f"{1 + i % 8} {i} {x} {y} {w} {h}\n" for i, x, y, w, h in rows))
    return str(root)


def _config(root, dataset, **kw):
    cfg = {"DATASET": dataset, "DATA_ROOT": root, "SEED": 7,
           "SAMPLE_STEPS": [1, 2], "SAMPLE_LENGTHS": [2, 3, 4],
           "SAMPLE_MODES": ["random_interval"], "SAMPLE_INTERVALS": [2, 3],
           "COCO_SIZE": False, "OVERFLOW_BBOX": False, "REVERSE_CLIP": 0.0,
           "BATCH_SIZE": 2, "NUM_WORKERS": 1, "MAX_GTS": 2,
           "USE_CROWDHUMAN": True, "USE_MOTSYNTH": True, "MOTSYNTH_RATE": 0.5,
           "TRAIN_SHORT_SIDES": [48, 64], "TRAIN_MAX_SIZE": 128}
    cfg.update(kw)
    return cfg


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def assert_clips_equal(got, want):
    assert len(got["imgs"]) == len(want["imgs"])
    for a, b in zip(got["imgs"], want["imgs"]):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for a, b in zip(got["infos"], want["infos"]):
        assert set(a) == set(b)
        np.testing.assert_allclose(a["boxes"], b["boxes"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(a["areas"], b["areas"], rtol=1e-6)
        for k in ("ids", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
        for k in set(a) - {"boxes", "areas", "ids", "labels"}:
            assert a[k] == b[k], k


DATASETS = ["DanceTrack", "SportsMOT", "MOT17", "BDD100K"]


@pytest.mark.parametrize("dataset", DATASETS)
def test_dataset_gts_offsets_and_curriculum_match_jax(root, dataset):
    cfg = _config(root, dataset)
    _seed(0)
    jds = jax_data.build_dataset(cfg, "train")
    pds = port_data.build_dataset(cfg, "train")
    assert type(pds).__name__ == type(jds).__name__
    if dataset == "MOT17":
        assert pds.mot17_gts == jds.mot17_gts
        assert pds.crowdhuman_gts == jds.crowdhuman_gts
        assert pds.motsynth_gts == jds.motsynth_gts
        assert list(pds.mot17_gts) == ["MOT17-02-SDP"]
    else:
        assert pds.gts == jds.gts and pds.vid_idx == jds.vid_idx
    lengths = []
    for epoch in range(3):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        assert pds.sample_begin_frames == jds.sample_begin_frames, epoch
        assert (pds.sample_length, pds.sample_interval) == \
            (jds.sample_length, jds.sample_interval)
        lengths.append(pds.sample_length)
        for item in (0, len(pds) - 1):
            _seed(100 + epoch)
            want = jds[item]
            _seed(100 + epoch)
            got = pds[item]
            assert len(got["imgs"]) == pds.sample_length
            assert_clips_equal(got, want)
    assert lengths == [2, 3, 4]


def test_id_offsets_per_video(root):
    ds = port_data.build_dataset(_config(root, "DanceTrack"), "train")
    ids = {}
    for vid, begin in (ds.sample_begin_frames[0], ds.sample_begin_frames[-1]):
        ids[vid] = set(ds.load_frame(vid, begin)[1]["ids"].tolist())
    assert ids == {"v1": {1, 2, 3}, "v2": {100001, 100002, 100003}}


def _pil_clip(seed, n=2, hw=(H, W)):
    rng = np.random.default_rng(seed)
    imgs = [PIL.Image.fromarray(rng.integers(0, 255, hw + (3,), np.uint8))
            for _ in range(n)]
    infos = []
    for t in range(n):
        b = np.asarray([[x, y, x + w, y + h] for _, x, y, w, h in
                        _rows(t, 4, big=True)], np.float32)
        infos.append({"boxes": b, "ids": np.arange(4) + 10,
                      "labels": np.asarray([0, 1, 0, 2]),
                      "areas": (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])})
    return imgs, infos


def _as_clip(imgs, infos):
    return {"imgs": [np.asarray(i, np.float32) for i in imgs], "infos": infos}


TRANSFORMS = {
    "flip": lambda m: m.MultiRandomHorizontalFlip(),
    "resize": lambda m: m.MultiRandomResize([40, 60, 80], max_size=120),
    "resize_wh": lambda m: m.MultiRandomResize([(80, 50), (64, 40)]),
    "crop": lambda m: m.MultiRandomCrop(20, 50),
    "crop_overflow": lambda m: m.MultiRandomCrop(20, 50, overflow_bbox=True),
    "shift": lambda m: m.MultiRandomShift(max_shift=8),
    "hsv": lambda m: m.MultiHSV(),
    "normalize": lambda m: m.MultiNormalize(),
    "reverse": lambda m: m.MultiReverseClip(reverse=0.5),
    "select": lambda m: m.MultiRandomSelect(
        m.MultiRandomHorizontalFlip(p=1.0), m.MultiRandomCrop(20, 50)),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_each_transform_matches_jax(name):
    for seed in range(6):
        _seed(seed)
        want = _as_clip(*TRANSFORMS[name](jt)(*_pil_clip(seed, n=3)))
        jstate = (random.getstate(), np.random.get_state()[1].copy())
        _seed(seed)
        got = _as_clip(*TRANSFORMS[name](pt)(*_pil_clip(seed, n=3)))
        assert_clips_equal(got, want)
        # the same number of draws from each generator
        assert random.getstate() == jstate[0]
        np.testing.assert_array_equal(np.random.get_state()[1], jstate[1])


STACKS = {
    "default": {},
    "coco_size": {"coco_size": True},
    "overflow_bbox": {"overflow_bbox": True},
    "reverse_clip": {"reverse_clip": 0.5},
    "short_sides": {"sizes": [48, 64], "max_size": 128, "reverse_clip": 0.5},
}


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_training_stacks_match_jax(stack):
    kw = STACKS[stack]
    for seed in range(4):
        _seed(seed)
        want = jt.transforms_for_train(**kw)(*_pil_clip(seed))
        _seed(seed)
        got = pt.transforms_for_train(**kw)(*_pil_clip(seed))
        assert_clips_equal({"imgs": got[0], "infos": got[1]},
                           {"imgs": want[0], "infos": want[1]})


def test_eval_stack_matches_jax():
    want = jt.transforms_for_eval()(*_pil_clip(0))
    got = pt.transforms_for_eval()(*_pil_clip(0))
    assert max(got[0][0].shape[:2]) <= 1333
    assert_clips_equal({"imgs": got[0], "infos": got[1]},
                       {"imgs": want[0], "infos": want[1]})


def _batches(loader, epoch):
    loader.set_epoch(epoch)
    return list(loader)


@pytest.mark.parametrize("dataset", DATASETS)
@pytest.mark.parametrize("rank", [0, 1])
def test_loader_matches_jax_at_one_worker(root, dataset, rank):
    """Every batch and gt_dropped equal over 2 epochs (the second one's
    clips are longer), rank ``rank`` of 2, on a fixed canvas (MOT17, which
    has no ``TRAIN_SHORT_SIDES`` and resizes to 608-992, on its buckets)."""
    canvas = None if dataset == "MOT17" else (128, 128)
    cfg = _config(root, dataset)
    loaders = []
    for pkg, cls in ((jax_data, JaxDataLoader), (port_data, DataLoader)):
        loaders.append(cls(pkg.build_dataset(cfg, "train"), batch_size=2,
                           max_gts=2, num_workers=1, seed=7, rank=rank,
                           world_size=2, fixed_canvas=canvas))
    dropped = 0
    for epoch in range(2):
        _seed(epoch)
        want = _batches(loaders[0], epoch)
        _seed(epoch)
        got = _batches(loaders[1], epoch)
        assert len(got) == len(want) == len(loaders[1]) > 0
        for g, w in zip(got, want):
            assert set(g) == set(w)
            assert canvas is None or g["images"].shape[2:4] == canvas
            np.testing.assert_allclose(g["images"], w["images"], rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(g["gt_boxes"], w["gt_boxes"], rtol=0,
                                       atol=1e-5)
            for k in ("mask", "gt_ids", "gt_labels", "gt_mask"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g["gt_dropped"] == w["gt_dropped"]
            dropped += g["gt_dropped"]
    assert dropped > 0


class _IndexDataset:
    """Clip ``j`` is one frame filled with ``j``: batches show the order."""

    def __init__(self, n):
        self.n = n
        self.epochs = []

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def _clip(self, j):
        return {"imgs": [np.full((4, 4, 3), j, np.float32)],
                "infos": [{"boxes": np.zeros((0, 4), np.float32),
                           "ids": np.zeros(0), "labels": np.zeros(0),
                           "areas": np.zeros(0)}]}

    def __getitem__(self, j):
        return self._clip(j)

    def get(self, j, rng):
        return self._clip(j)


def test_loader_order_matches_jax_at_three_workers():
    for rank in (0, 1):
        got, want = [], []
        for cls, out in ((DataLoader, got), (JaxDataLoader, want)):
            ds = _IndexDataset(23)
            loader = cls(ds, batch_size=3, max_gts=2, num_workers=3, seed=5,
                         rank=rank, world_size=2)
            for epoch in range(2):
                loader.set_epoch(epoch)
                out.append([b["images"][:, 0, 0, 0, 0].tolist()
                            for b in loader])
            assert ds.epochs == [0, 1]
        assert got == want and len(got[0]) == 3


def test_loader_is_deterministic_at_three_workers(root):
    """Several workers: per-batch generators, the same batches every run."""
    cfg = _config(root, "DanceTrack", NUM_WORKERS=3)
    runs = []
    for seed in (0, 1):
        _seed(seed)         # the process-wide generators play no part
        loader = port_data.build_dataloader(
            port_data.build_dataset(cfg, "train"), cfg)
        runs.append(_batches(loader, 1))
    for a, b in zip(*runs):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_loader_raises_worker_errors_and_stops_early():
    class Failing(_IndexDataset):
        def get(self, j, rng):
            if j == 7:
                raise OSError("unreadable frame")
            return self._clip(j)

    loader = DataLoader(Failing(12), batch_size=1, max_gts=2, num_workers=3,
                        shuffle=False)
    with pytest.raises(RuntimeError, match="worker failed") as e:
        list(loader)
    assert isinstance(e.value.__cause__, OSError)
    before = threading.active_count()
    loader = DataLoader(_IndexDataset(40), batch_size=1, max_gts=2,
                        num_workers=4)
    for i, _ in enumerate(loader):
        if i == 2:
            break
    assert threading.active_count() <= before
