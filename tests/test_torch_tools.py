"""The port's inference tools and profiling hooks on the CPU, at the tiny
size of tests/test_serving.py (the deformable model: C = 32, 12 detection
queries, 8 slots, 1 encoder and 2 decoder layers, float32):

- ``tools.export_serving`` on a port epoch checkpoint (a training run's
  directory: ``train/config.yaml`` and ``checkpoint_1.pth``), its artifact
  stepped by ``ServingRuntime``;
- ``tools.demo`` on a 5-frame synthetic XVID video: 5 annotated frames out;
- ``tools.reproduce_dancetrack`` dry-run on a synthetic DanceTrack val
  split (2 videos of 4 JPEG frames with their ``gt.txt``, the tree of
  ``tests/test_torch_eval.py``) and a reference-format ``.pth`` of a
  seeded port model, from a config without ``USE_DAB`` (the shared
  default, True, must read the DAB checkpoint strictly): its JSON line's
  keys and values against the port's own ``eval_model`` on the same
  directories, the ``--expected-hota`` exit codes both ways, the
  checkpoint loaded strictly;
- ``utils/profiling``: ``StepTimer`` skips the first step,
  ``device_memory_stats`` is ``{}`` on the CPU, ``trace`` writes a Chrome
  trace with the ``annotate`` range in it.
"""
import json
import os
from contextlib import redirect_stdout
from io import StringIO

import numpy as np
import pytest
import torch

from memotr_tpu_torch.checkpoint.files import save_checkpoint
from memotr_tpu_torch.config import dict_to_yaml, yaml_to_dict
from memotr_tpu_torch.models.memotr import build_model
from memotr_tpu_torch.serving import ServingRuntime
from memotr_tpu_torch.tools import demo, export_serving, reproduce_dancetrack
from memotr_tpu_torch.utils import profiling
from test_torch_eval import N_FRAMES, VIDEOS, _tree
from test_torch_port_weights import randomize_
from test_torch_serving import CONFIG, SLOTS, one_torch_thread  # noqa: F401

HW = (72, 128)
TOOL_CFG = dict(CONFIG, EVAL_SHORT_SIDE=HW[0], EVAL_MAX_SIDE=HW[1],
                EVAL_THREADS=1, DET_SCORE_THRESH=0.3, TRACK_SCORE_THRESH=0.3,
                RESULT_SCORE_THRESH=0.3, MISS_TOLERANCE=5)
N_DEMO = 5


def seeded_model(seed=11):
    """Weights whose detections fire (the eval tests' ``_model``)."""
    torch.manual_seed(0)
    model = randomize_(build_model(TOOL_CFG), seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                mod.weight.add_(1.0)
        model.det_query_embed.mul_(12.5)
        model.det_anchor.mul_(12.5)
    return model


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A training run's directory as the port's ``train()`` writes it."""
    path = tmp_path_factory.mktemp("run")
    os.makedirs(path / "train")
    dict_to_yaml(TOOL_CFG, str(path / "train" / "config.yaml"))
    save_checkpoint(str(path / "checkpoint_1.pth"), seeded_model())
    return path


def test_export_serving_on_an_epoch_checkpoint(run_dir, tmp_path):
    out = str(tmp_path / "artifact")
    with redirect_stdout(StringIO()):
        export_serving.main(["--submit-dir", str(run_dir), "--submit-model",
                             "checkpoint_1", "--out", out, "--height", "64",
                             "--width", "96", "--device", "cpu"])
    rt = ServingRuntime.load(out)
    assert rt.manifest["canvas_hw"] == [64, 96]
    assert rt.manifest["platforms"] == ["cpu"]
    rows = rt.step(np.zeros((64, 96, 3), np.uint8), np.zeros((64, 96), bool))
    assert rows.shape == (SLOTS, 9) and np.isfinite(rows).all()


def test_demo_on_a_synthetic_video(run_dir, tmp_path):
    import cv2
    video, out = str(tmp_path / "in.avi"), str(tmp_path / "out.avi")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"XVID"), 25,
                             (HW[1], HW[0]))
    rng = np.random.default_rng(0)
    for _ in range(N_DEMO):
        writer.write(rng.integers(0, 255, HW + (3,), np.uint8))
    writer.release()
    with redirect_stdout(StringIO()):
        n = demo.main(["--config", str(run_dir / "train" / "config.yaml"),
                       "--checkpoint", str(run_dir / "checkpoint_1.pth"),
                       "--video", video, "--out", out, "--score-thresh",
                       "0.3", "--device", "cpu"])
    cap = cv2.VideoCapture(out)
    n_out = 0
    while cap.read()[0]:
        n_out += 1
    cap.release()
    assert n == n_out == N_DEMO


def test_demo_canvas_is_the_stream_resize():
    canvas, mask = demo.canvas_frame(np.full((36, 128, 3), 7, np.uint8), 72,
                                     128)
    assert canvas.shape == (72, 128, 3) and mask.shape == (72, 128)
    assert not mask[:36].any() and mask[36:].all()
    assert demo.color_for_id(3) == demo.color_for_id(3) != \
        demo.color_for_id(4)


@pytest.fixture(scope="module")
def repro(tmp_path_factory):
    """A DanceTrack val tree, a ``.pth`` of a seeded port model and an
    architecture config without ``USE_DAB``."""
    tmp = tmp_path_factory.mktemp("repro")
    _tree(str(tmp / "data"))
    pth = str(tmp / "memotr_dancetrack.pth")
    torch.save({"model": seeded_model().state_dict()}, pth)
    cfg = {k: v for k, v in TOOL_CFG.items() if k != "USE_DAB"}
    dict_to_yaml(cfg, str(tmp / "arch.yaml"))
    return tmp, pth


def run_repro(tmp, pth, out, *extra):
    buf = StringIO()
    with redirect_stdout(buf):
        rc = reproduce_dancetrack.main(
            ["--checkpoint", pth, "--data-root", str(tmp / "data"), "--out",
             str(tmp / out), "--config", str(tmp / "arch.yaml"), "--device",
             "cpu", *extra])
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_reproduce_dancetrack_dry_run(repro):
    tmp, pth = repro
    rc, res = run_repro(tmp, pth, "out")
    assert rc == 0
    assert set(res) == {"HOTA", "DetA", "AssA", "MOTA", "IDF1", "split",
                        "published_test"}
    assert res["split"] == "val" and res["published_test"]["HOTA"] == 68.5
    assert all(np.isfinite(res[k]) for k in ("HOTA", "DetA", "AssA"))
    written = yaml_to_dict(str(tmp / "out" / "train" / "config.yaml"))
    assert written["USE_DAB"] is True
    tracker = tmp / "out" / "val" / "memotr_dancetrack_tracker"
    assert sorted(os.listdir(tracker)) == sorted(
        [f"{v}.txt" for v in VIDEOS] + ["pedestrian_summary.txt"])
    with open(tracker / f"{VIDEOS[0]}.txt") as f:
        frames = {int(line.split(",")[0]) for line in f}
    assert frames and frames <= set(range(1, N_FRAMES + 1))
    with open(tmp / "out" / "val" / "memotr_dancetrack_metrics.json") as f:
        metrics = json.loads(f.readline())
    for k in ("HOTA", "DetA", "AssA", "MOTA", "IDF1"):
        assert res[k] == round(float(metrics[k]), 3)

    rc, hit = run_repro(tmp, pth, "out", "--expected-hota",
                        str(res["HOTA"] + 0.2), "--tolerance", "0.5")
    assert rc == 0 and hit["pass"] is True and hit["HOTA"] == res["HOTA"]
    rc, miss = run_repro(tmp, pth, "out", "--expected-hota",
                         str(res["HOTA"] + 5.0))
    assert rc == 1 and miss["pass"] is False
    assert miss["delta"] == pytest.approx(-5.0, abs=1e-3)


def test_reproduce_loads_the_checkpoint_strictly(repro):
    tmp, pth = repro
    sd = torch.load(pth, weights_only=True)["model"]
    sd["unexpected.weight"] = torch.zeros(1)
    bad = str(tmp / "bad.pth")
    torch.save({"model": sd}, bad)
    with pytest.raises(RuntimeError, match="unexpected.weight"), \
            redirect_stdout(StringIO()):
        reproduce_dancetrack.main(
            ["--checkpoint", bad, "--data-root", str(tmp / "data"), "--out",
             str(tmp / "bad"), "--config", str(tmp / "arch.yaml"),
             "--device", "cpu"])


def test_reproduce_default_config_is_the_release_shape():
    cfg = yaml_to_dict(reproduce_dancetrack.DEFAULT_CONFIG)
    assert cfg["HIDDEN_DIM"] == 256 and cfg["NUM_DET_QUERIES"] == 300
    assert cfg.get("USE_DAB", True) is True


def test_step_timer_skips_the_first_step():
    timer = profiling.StepTimer(skip_first=1)
    for _ in range(3):
        with timer:
            pass
    assert timer.count == 2 and timer.mean >= 0.0


def test_device_memory_stats_empty_on_cpu():
    assert profiling.device_memory_stats("cpu") == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("serving step"):
            torch.ones(8) @ torch.ones(8)
    assert any(e.key == "serving step" for e in prof.key_averages())
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "serving step" in f.read()
