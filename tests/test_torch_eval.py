"""The port's evaluation entry, ``python -m memotr_tpu_torch.main --mode
eval`` (``engine/eval.py``), on the CPU, against the JAX package's metrics.

A synthetic DanceTrack tree (val: 2 videos of 4 JPEG frames, 72x128, three
moving boxes each) and an eval directory as the port's training writes it:
``train/config.yaml`` of the tiny deformable MeMOTR of
tests/test_torch_train_loop.py (1 encoder and 2 decoder layers, float32)
and two epoch checkpoints, ``checkpoint_0.pth`` and ``checkpoint_1.pth``,
of seeded weights whose detections fire.  Checked:

- ``specific`` through the CLI (a subprocess, ``EVAL_THREADS`` 2, so the
  spawned pool scores the two sequences): the outputs carry the JAX
  package's names (``val/checkpoint_1_tracker/`` with
  ``pedestrian_summary.txt``, ``val/checkpoint_1_metrics.json``, a
  ``scalars.jsonl`` record at step 1), and the metrics equal JAX's
  ``evaluate_mot_challenge`` on the same tracker and GT directories
  (1e-12), as does the summary file, byte for byte, JAX's ``write_summary``;
- a seqmap selects its subset;
- ``continue`` with both checkpoints in place scores both in order, ends
  with ``eval_states.yaml`` at ``last: 1`` and never sleeps;
- without a card, ``--mode eval`` on ``cuda`` raises;
- the new modules import no JAX.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import PIL.Image
import pytest
import torch
import yaml

from memotr_tpu.metrics.evaluator import evaluate_mot_challenge as jax_eval
from memotr_tpu.metrics.evaluator import write_summary as jax_write_summary
from memotr_tpu_torch.checkpoint.files import save_checkpoint
from memotr_tpu_torch.config import dict_to_yaml
from memotr_tpu_torch.engine import eval as port_eval
from memotr_tpu_torch.main import main
from memotr_tpu_torch.models.memotr import build_model
from test_torch_port_weights import randomize_
from test_torch_train_loop import MODEL_CFG, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEOS = ("dancetrack0004", "dancetrack0007")
N_FRAMES = 4
THRESH = 0.3


def _tree(root):
    """val: each video 4 JPEG frames of noise and its gt.txt (3 boxes)."""
    for k, name in enumerate(VIDEOS):
        rng = np.random.default_rng(k)
        vdir = os.path.join(root, "DanceTrack", "val", name)
        os.makedirs(os.path.join(vdir, "img1"))
        os.makedirs(os.path.join(vdir, "gt"))
        lines = []
        for t in range(1, N_FRAMES + 1):
            PIL.Image.fromarray(rng.integers(30, 200, (72, 128, 3), np.uint8)
                                ).save(os.path.join(vdir, "img1",
                                                    f"{t:08d}.jpg"))
            lines += [f"{t},{o + 1},{8 + 30 * o + 3 * t + k},{10 + 6 * o},"
                      f"26,34,1,1,1\n" for o in range(3)]
        with open(os.path.join(vdir, "gt", "gt.txt"), "w") as f:
            f.writelines(lines)


def _model(seed):
    """Seeded weights whose detections fire (the train-step tests')."""
    torch.manual_seed(0)
    model = randomize_(build_model(MODEL_CFG), seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                mod.weight.add_(1.0)
        model.det_query_embed.mul_(12.5)
        model.det_anchor.mul_(12.5)
    return model


def _eval_dir(path):
    """``train/config.yaml`` and two epoch checkpoints, as train() writes
    them."""
    os.makedirs(os.path.join(path, "train"))
    dict_to_yaml(dict(MODEL_CFG), os.path.join(path, "train", "config.yaml"))
    for epoch, seed in ((0, 12), (1, 11)):
        save_checkpoint(os.path.join(path, f"checkpoint_{epoch}.pth"),
                        _model(seed), states={"start_epoch": epoch + 1,
                                              "global_iters": 2 * epoch + 2})
    return path


def _config(tmp, eval_dir, **kw):
    cfg = dict(MODEL_CFG, MODE="eval", DATA_ROOT=str(tmp / "data"),
               EVAL_DIR=eval_dir,
               EVAL_MODE="specific", EVAL_MODEL="checkpoint_1.pth",
               EVAL_THREADS=2, EVAL_DATA_SPLIT="val", EPOCHS=2,
               EVAL_SHORT_SIDE=72, EVAL_MAX_SIDE=128,
               DET_SCORE_THRESH=THRESH, TRACK_SCORE_THRESH=THRESH,
               RESULT_SCORE_THRESH=THRESH, MISS_TOLERANCE=5)
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    _tree(str(tmp / "data"))
    eval_dir = _eval_dir(str(tmp / "run"))
    cfg_path = tmp / "eval.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(_config(tmp, eval_dir, EVAL_MODEL=None), f)
    res = subprocess.run(
        [sys.executable, "-m", "memotr_tpu_torch.main", "--mode", "eval",
         "--config-path", str(cfg_path), "--eval-model", "checkpoint_1.pth",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-4000:]
    return tmp, eval_dir, res.stdout


def test_outputs_carry_the_checkpoint_names(cli_run):
    _, eval_dir, stdout = cli_run
    val = os.path.join(eval_dir, "val")
    tracker = os.path.join(val, "checkpoint_1_tracker")
    assert sorted(os.listdir(tracker)) == sorted(
        [f"{v}.txt" for v in VIDEOS] + ["pedestrian_summary.txt"])
    assert not os.path.exists(os.path.join(val, "tracker"))
    for v in VIDEOS:
        with open(os.path.join(tracker, f"{v}.txt")) as f:
            rows = [line.split(",") for line in f]
        assert rows, f"{v}: no MOT lines"
        assert {int(r[0]) for r in rows} <= set(range(1, N_FRAMES + 1))
    with open(os.path.join(val, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 1 and recs[0]["step"] == 1 \
        and recs[0]["mode"] == "epochs"
    assert "[eval checkpoint_1]" in stdout


def test_metrics_equal_jax(cli_run):
    tmp, eval_dir, _ = cli_run
    with open(os.path.join(eval_dir, "val", "checkpoint_1_metrics.json")) as f:
        got = json.loads(f.read())
    tracker = os.path.join(eval_dir, "val", "checkpoint_1_tracker")
    want = jax_eval(str(tmp / "data" / "DanceTrack" / "val"), tracker,
                    dataset="DanceTrack", num_parallel=1)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(float(v), rel=0, abs=1e-12), k
    assert got["Dets"] > 0 and got["GT_IDs"] == 6
    with open(os.path.join(eval_dir, "val", "scalars.jsonl")) as f:
        rec = json.loads(f.readline())
    assert rec["HOTA"] == pytest.approx(want["HOTA"], abs=1e-12)
    jax_write_summary(want, str(tmp / "jax_summary" / "s.txt"))
    with open(os.path.join(tracker, "pedestrian_summary.txt"), "rb") as f:
        assert f.read() == (tmp / "jax_summary" / "s.txt").read_bytes()


def test_seqmap_selects_its_subset(cli_run, tmp_path):
    tmp, eval_dir, _ = cli_run
    shutil.copytree(tmp / "data", tmp_path / "data")
    (tmp_path / "data" / "DanceTrack" / "val_seqmap.txt").write_text(
        f"name\n{VIDEOS[1]}\n")
    run = _eval_dir(str(tmp_path / "run"))
    got = port_eval.evaluate(_config(tmp_path, run, EVAL_THREADS=1),
                             device="cpu")
    tracker = os.path.join(run, "val", "checkpoint_1_tracker")
    want = jax_eval(str(tmp_path / "data" / "DanceTrack" / "val"), tracker,
                    seq_names=[VIDEOS[1]], dataset="DanceTrack",
                    num_parallel=1)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(float(v), rel=0, abs=1e-12), k
    assert got["GT_IDs"] == 3


def test_continue_scores_every_checkpoint_without_sleeping(
        cli_run, tmp_path, monkeypatch):
    tmp, _, _ = cli_run

    def no_sleep(seconds):
        raise AssertionError(f"continue mode slept {seconds} s")
    monkeypatch.setattr(port_eval.time, "sleep", no_sleep)
    run = _eval_dir(str(tmp_path / "run"))
    cfg = _config(tmp, run, EVAL_MODE="continue", EVAL_MODEL=None,
                  EVAL_THREADS=1)
    assert port_eval.evaluate(cfg, device="cpu") is None
    with open(os.path.join(run, "eval_states.yaml")) as f:
        assert yaml.safe_load(f) == {"last": 1}
    val = os.path.join(run, "val")
    for e in (0, 1):
        assert os.path.isfile(os.path.join(val, f"checkpoint_{e}_metrics.json"))
        assert os.path.isfile(os.path.join(val, f"checkpoint_{e}_tracker",
                                           "pedestrian_summary.txt"))
    with open(os.path.join(val, "scalars.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [0, 1]
    # the cursor is at the last epoch: a second call scores nothing
    assert port_eval.evaluate(cfg, device="cpu") is None
    with open(os.path.join(val, "scalars.jsonl")) as f:
        assert len(f.readlines()) == 2


def test_checkpoint_epoch_from_the_file_stem():
    assert port_eval.checkpoint_epoch("checkpoint_12") == 12
    assert port_eval.checkpoint_epoch("checkpoint_iter3") == 0
    assert port_eval.checkpoint_epoch("model") == 0


def test_eval_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg_path = tmp_path / "eval.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(_config(tmp_path, str(tmp_path / "run")), f)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--mode", "eval", "--config-path", str(cfg_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_eval.evaluate(_config(tmp_path, str(tmp_path / "run")))
    assert not os.path.exists(tmp_path / "run")


def test_eval_modules_import_no_jax():
    mods = ["memotr_tpu_torch.metrics", "memotr_tpu_torch.metrics.evaluator",
            "memotr_tpu_torch.metrics.track_map", "memotr_tpu_torch.engine.eval",
            "memotr_tpu_torch.main"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'memotr_tpu', 'cv2', "
            "'yaml')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
