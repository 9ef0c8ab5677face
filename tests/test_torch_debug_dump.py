"""``VISUALIZE`` debug dumps (``memotr_tpu_torch/utils/debug_dump.py``)
against the JAX package's, at the tiny size of tests/test_serving.py
(C = 32, 12 detection queries, 8 slots, 1 encoder and 2 decoder layers,
float32, CPU).

- Submit: a 3-frame PNG sequence (64x128, the whole 64x128 canvas)
  through JAX's ``Submitter`` and the port's, both with ``VISUALIZE`` (the
  sync loop; JAX's eval step is this file's one JAX compile) and the
  weights of one seeded JAX tree: the same ``frame_{i:06d}.npz`` files
  under ``visualize/<seq>``, the same keys (``results.*`` and
  ``state.*``), integer and boolean arrays equal, float arrays within 1e-4
  (float32 sums in another order).  The frames fill the canvas because
  JAX's sync loop normalizes on the host and pads the canvas after (a
  padded pixel is 0 after normalization), while its pipelined loop and
  every loop of the port pad the uint8 frame first (a padded pixel is
  black): on a padded canvas JAX's two loops differ from each other.
- Training: the port's ``train()`` with ``VISUALIZE`` on a one-video
  DanceTrack tree writes ``visualize_train/frame_<iteration>.npz`` with
  JAX's training keys (``results.frame{f}.*``) and shapes.
- The dumper writes nothing when disabled; ``BatchedSubmitter`` refuses
  ``VISUALIZE``.
"""
import os

import numpy as np
import pytest
import torch

from memotr_tpu.engine.submit import Submitter as JaxSubmitter
from memotr_tpu.models.memotr import build_model as jax_build_model
from memotr_tpu.models.query_updater import build_query_updater
from memotr_tpu_torch.checkpoint.convert import state_dict_from_jax
from memotr_tpu_torch.engine import train as port_train
from memotr_tpu_torch.engine.submit import BatchedSubmitter, Submitter
from memotr_tpu_torch.models.memotr import build_model
from memotr_tpu_torch.utils.debug_dump import DebugDumper
from test_torch_serving import C, CONFIG, SLOTS, jax_trees
from test_torch_serving import one_torch_thread  # noqa: F401
from test_torch_submit import seq_frames
from test_torch_train_loop import _config, _tree

N_FRAMES = 3
VIS_CFG = dict(CONFIG, VISUALIZE=True, EVAL_SHORT_SIDE=64, EVAL_MAX_SIDE=128)
VALUE_ATOL = 1e-4
STATE_KEYS = {"mask", "ids", "labels", "disappear_time", "next_id",
              "query_embed", "ref_pts", "logits", "boxes", "output_embed",
              "last_output", "long_memory", "last_appear_boxes",
              "matched_idx", "iou"}


def write_sequence(root):
    """A DanceTrack-layout PNG sequence of N_FRAMES 64x128 frames: noise
    and a textured block that moves."""
    import cv2
    rng = np.random.default_rng(0)
    img_dir = os.path.join(root, "seq", "img1")
    os.makedirs(img_dir)
    bg = rng.integers(30, 130, (64, 128, 3), np.uint8)
    tex = rng.integers(120, 255, (20, 16, 3), np.uint8)
    for t in range(N_FRAMES):
        img = bg.copy()
        img[18:38, 10 + 7 * t:26 + 7 * t] = tex
        cv2.imwrite(os.path.join(img_dir, f"{t + 1:08d}.png"),
                    img[:, :, ::-1])                       # RGB -> BGR
    return os.path.join(root, "seq")


def _load_dir(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with np.load(os.path.join(path, name)) as z:
            out[name] = {k: z[k] for k in z.files}
    return out


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("visualize")
    seq_dir = write_sequence(str(tmp / "data"))
    params, uparams, frozen = jax_trees(VIS_CFG, seed=5)
    jsub = JaxSubmitter("DanceTrack", seq_dir, "seq", str(tmp / "jax"),
                        jax_build_model(VIS_CFG), build_query_updater(VIS_CFG),
                        {"params": params, "frozen": frozen},
                        {"params": uparams}, VIS_CFG)
    assert not jsub.pipelined
    jsub.run()
    model = build_model(VIS_CFG)
    model.load_state_dict(state_dict_from_jax(params, uparams, frozen))
    sub = Submitter("DanceTrack", iter(seq_frames(seq_dir)), "seq",
                    str(tmp / "port"), model.eval(), VIS_CFG, "cpu")
    assert not sub.pipelined
    sub.run()
    return (_load_dir(str(tmp / "jax" / "visualize" / "seq")),
            _load_dir(str(tmp / "port" / "visualize" / "seq")))


def test_submit_dumps_match_jax(dumps):
    want, got = dumps
    assert sorted(got) == sorted(want) == [f"frame_{i:06d}.npz"
                                           for i in range(N_FRAMES)]
    for name, arrays in want.items():
        assert set(got[name]) == set(arrays), (
            name, sorted(set(got[name]) ^ set(arrays)))
        for key, w in arrays.items():
            g = got[name][key]
            assert g.shape == w.shape, (name, key, g.shape, w.shape)
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=0, atol=VALUE_ATOL,
                                           err_msg=f"{name} {key}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{name} {key}")


def test_submit_dump_keys(dumps):
    arrays = dumps[1]["frame_000002.npz"]
    assert set(arrays) == {f"results.{k}" for k in (
        "ids", "labels", "boxes", "scores", "mask")} | {
        f"state.{k}" for k in STATE_KEYS}
    assert arrays["results.mask"].any(), "no live track in the dump"


def test_train_dumps_keys_and_shapes(tmp_path):
    _tree(str(tmp_path / "data"))
    sizes = {k: CONFIG[k] for k in (
        "HIDDEN_DIM", "FFN_DIM", "NUM_HEADS", "NUM_DET_QUERIES",
        "NUM_ENC_LAYERS", "NUM_DEC_LAYERS", "TRACK_SLOTS")}
    torch.manual_seed(0)
    torch.save({"model": build_model(dict(_config(tmp_path, "x"), **sizes))
                .state_dict()}, str(tmp_path / "pretrained.pth"))
    cfg = _config(tmp_path, "out", EPOCHS=1, VISUALIZE=True, **sizes)
    port_train.train(cfg, device="cpu")
    dump_dir = tmp_path / "out" / "visualize_train"
    arrays = _load_dir(str(dump_dir))
    assert sorted(arrays) == ["frame_000000.npz", "frame_000001.npz"]
    n, t = CONFIG["NUM_DET_QUERIES"] + SLOTS, cfg["SAMPLE_LENGTHS"][0]
    shapes = {"pred_logits": (1, n, 1), "pred_boxes": (1, n, 4),
              "last_ref_pts": (1, n, 4), "track_query_embed": (1, SLOTS, C),
              "track_long_memory": (1, SLOTS, C), "track_mask": (1, SLOTS)}
    for name, got in arrays.items():
        want = {f"results.frame{f}.{k}": s for f in range(t)
                for k, s in shapes.items()}
        assert {k: v.shape for k, v in got.items()} == want, name
        assert got["results.frame0.track_mask"].dtype == bool


def test_disabled_dumper_writes_nothing(tmp_path):
    DebugDumper(str(tmp_path / "off")).dump_frame(0, x=torch.zeros(2))
    assert not os.path.exists(tmp_path / "off")
    dumper = DebugDumper(str(tmp_path / "on"), enabled=True)
    dumper.dump_frame(7, x=torch.ones(2), tree={"a": {"b": np.zeros(3)}})
    with np.load(tmp_path / "on" / "frame_000007.npz") as z:
        assert sorted(z.files) == ["tree.a.b", "x"]


def test_batched_submitter_refuses_visualize(tmp_path):
    model = build_model(VIS_CFG)
    with pytest.raises(ValueError, match="VISUALIZE needs the sequential"):
        BatchedSubmitter("DanceTrack", [[]], ["seq"], str(tmp_path), model,
                         VIS_CFG, "cpu")
