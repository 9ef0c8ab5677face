"""The port's ``tools/flagship_eval`` against ``tools/flagship_eval.py``
(numpy and PIL; no JAX step is compiled), and a tiny campaign through it
on the CPU.

- The worlds: ``make_synvalue`` (v2) and ``make_synvalue_v3`` write the
  same JPEG bytes and ``gt.txt`` as the JAX tool's, at two seeds.
- The configs: ``base_config`` of every encoder family, ``VARIANTS``,
  ``TEACHER_VARIANTS`` and the world's constants equal the JAX tool's.
- The bookkeeping of ``tests/test_campaign_tools.py`` on the port's files:
  reuse of a scored run, seed isolation, the teacher as a ``.pth``, the
  launch deadline and the hard stop (through ``main`` with the launch
  faked); ``latest_complete_checkpoint`` ignores a ``.pth.tmp``;
  ``PROXY_VERSION`` refuses a workdir of the other version; without a
  card ``--device cuda`` raises; importing any module of the port's
  ``tools/`` or ``chip_smoke.py`` loads no JAX, no JAX package and no root
  ``tools`` module.
- A tiny campaign: ``run_variant`` at ``device="cpu"`` trains and scores
  ``deformable`` and then ``windowed_transplant`` from its teacher, one
  epoch each, the model and world shrunk by wrapping ``base_config`` (the
  train-loop tests' widths, a 64x96 canvas, 2 sequences a split): the
  metrics files, the transplant's merge counts (every teacher tensor
  outside the encoder loaded, the encoder's skipped), reuse on a second
  call, a resume from the epoch checkpoint once the metrics are removed,
  and a missing teacher raising.
- ``epoch_iterations`` counts the port's dataset's clips of each epoch.
- ``scripts/campaign_h100.py``: the teacher carry (packed and unpacked,
  the model equals the original rounded to bfloat16), and its runs go
  through the tool's ``launch`` under the tool's hard stop.
"""
import filecmp
import importlib.util
import json
import os
import subprocess
import sys
import time

import pytest
import torch

import memotr_tpu_torch.engine.train as train_module
from memotr_tpu_torch.tools import flagship_eval as fe
from test_torch_train_loop import MODEL_CFG, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_HW = (64, 96)
TINY_FRAMES = 15          # v3 needs more than 14 frames a sequence


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_flagship_eval", os.path.join(ROOT, "tools", "flagship_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_metrics(workdir, variant, seed, epochs, hota):
    d = os.path.join(workdir, f"{variant}_s{seed}", "val")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"checkpoint_{epochs - 1}_metrics.json"),
              "w") as f:
        json.dump({"HOTA": hota, "DetA": 30.0, "AssA": 60.0, "MOTA": 20.0,
                   "IDF1": 40.0}, f)


def _same_tree(a, b):
    """Every file of two generated trees, byte for byte."""
    files = []
    for d, _, names in os.walk(a):
        files += [os.path.relpath(os.path.join(d, n), a) for n in names]
    assert files
    for rel in files:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                           shallow=False), rel
    n_b = sum(len(names) for _, _, names in os.walk(b))
    assert n_b == len(files)


@pytest.mark.parametrize("gen,n_frames", [("make_synvalue", 16),
                                          ("make_synvalue_v3", 20)])
@pytest.mark.parametrize("seed", [3, 99])
def test_generators_write_jax_bytes(tmp_path, gen, n_frames, seed):
    jax_fe = _jax_tool()
    getattr(jax_fe, gen)(str(tmp_path / "jax"), "train", 2, n_frames, seed)
    getattr(fe, gen)(str(tmp_path / "port"), "train", 2, n_frames, seed)
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_configs_equal_jax():
    jax_fe = _jax_tool()
    for k in ("H", "W", "PAD", "N_FRAMES", "N_TRAIN_SEQS", "N_VAL_SEQS",
              "N_FRAMES_V3"):
        assert getattr(fe, k) == getattr(jax_fe, k), k
    for enc in ("deformable", "windowed", "conv", "hybrid"):
        for epochs in (1, 10):
            assert fe.base_config("/d", "/o", enc, epochs) == \
                jax_fe.base_config("/d", "/o", enc, epochs)
    assert fe.VARIANTS == jax_fe.VARIANTS
    assert fe.TEACHER_VARIANTS == jax_fe.TEACHER_VARIANTS


def test_reuse_seed_isolation_and_teacher_path(tmp_path):
    w = str(tmp_path)
    assert fe.metrics_of(w, "windowed", 42, 10) is None
    _write_metrics(w, "windowed", 42, 10, 41.25)
    assert fe.metrics_of(w, "windowed", 42, 10)["HOTA"] == 41.25
    assert fe.run_variant("/no/data", w, "windowed", 10, 42, "cpu") == \
        fe.metrics_of(w, "windowed", 42, 10)
    assert fe.metrics_of(w, "windowed", 43, 10) is None
    assert fe.run_dir(w, "windowed", 43).endswith("windowed_s43")
    assert fe.teacher_ckpt(w, 10) == os.path.join(
        w, "deformable_s42", "checkpoint_9.pth")
    assert fe.teacher_ckpt(w, 10, "deformable_w256") == os.path.join(
        w, "deformable_w256_s42", "checkpoint_9.pth")


def test_latest_complete_checkpoint_ignores_tmp(tmp_path):
    out = str(tmp_path / "windowed_s42")
    assert fe.latest_complete_checkpoint(out) is None
    os.makedirs(os.path.join(out, "train"))
    for name in ("checkpoint_3.pth", "checkpoint_5.pth.tmp",
                 "checkpoint_iter2.pth", "checkpoint_7"):
        open(os.path.join(out, name), "w").close()
    assert fe.latest_complete_checkpoint(out) == 3
    open(os.path.join(out, "checkpoint_5.pth"), "w").close()
    assert fe.latest_complete_checkpoint(out) == 5


def test_proxy_version_guard(tmp_path, monkeypatch):
    for have, want in (("2", "3"), ("3", "2")):
        w = tmp_path / f"v{have}"
        (w / "data").mkdir(parents=True)
        (w / "data" / f".proxy_v{have}").write_text(f"proxy v{have}\n")
        monkeypatch.setenv("PROXY_VERSION", have)
        assert fe.ensure_data(str(w)) == str(w / "data")
        monkeypatch.setenv("PROXY_VERSION", want)
        with pytest.raises(RuntimeError, match=f"proxy v{have}"):
            fe.ensure_data(str(w))


def test_deadline_and_hard_stop(tmp_path, monkeypatch):
    """Through ``main`` with the launch faked: a hard stop 1000 s out caps
    the run's timeout; under ``MIN_RUN_WINDOW`` to it, or past the launch
    deadline, no run starts."""
    w = str(tmp_path)
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / ".proxy_v2").write_text("proxy v2\n")
    monkeypatch.delenv("PROXY_VERSION", raising=False)
    launched = []

    def fake_launch(workdir, epochs, name, seed, device, timeout):
        launched.append((name, seed, device, timeout))
        _write_metrics(workdir, name, seed, epochs, 50.0)
        return 0

    monkeypatch.setattr(fe, "launch", fake_launch)
    now = time.time()
    monkeypatch.setenv("FLAGSHIP_EVAL_DEADLINE", "0")
    monkeypatch.setenv("FLAGSHIP_EVAL_HARD_STOP", str(now + 1000))
    got = fe.main([w, "1", "windowed", "42", "--device", "cpu"])
    assert got == {"windowed_s42": fe.metrics_of(w, "windowed", 42, 1)}
    (name, seed, device, timeout), = launched
    assert (name, seed, device) == ("windowed", 42, "cpu")
    assert 900 < timeout <= 1000
    assert json.load(open(tmp_path / "flagship_eval.json")) == got

    monkeypatch.setenv("FLAGSHIP_EVAL_HARD_STOP", str(time.time() + 200))
    assert fe.main([w, "1", "deformable", "42", "--device", "cpu"]) == {}
    monkeypatch.setenv("FLAGSHIP_EVAL_HARD_STOP", "0")
    monkeypatch.setenv("FLAGSHIP_EVAL_DEADLINE", str(time.time() - 10))
    assert fe.main([w, "1", "deformable", "42", "--device", "cpu"]) == {}
    assert len(launched) == 1
    # a scored run is reported past the deadline too, without a launch
    assert fe.main([w, "1", "windowed", "42", "--device", "cpu"]) == got
    assert fe.run_timeout(0, now) == fe.RUN_TIMEOUT


def test_device_cuda_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fe.main([str(tmp_path / "w"), "1", "windowed", "42"])
    assert not os.path.exists(tmp_path / "w")


def test_tools_import_no_jax():
    """Every module of the port's ``tools/`` and ``chip_smoke.py``."""
    mods = sorted(
        f"memotr_tpu_torch.tools.{f[:-3]}" for f in os.listdir(
            os.path.join(ROOT, "memotr_tpu_torch", "tools"))
        if f.endswith(".py") and f != "__init__.py") + ["chip_smoke"]
    assert "memotr_tpu_torch.tools.flagship_eval" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'memotr_tpu', 'tools')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


# ------------------------------------------------------------ tiny campaign
def _tiny_base_config(orig):
    def base_config(root, outdir, encoder_type, epochs):
        cfg = orig(root, outdir, encoder_type, epochs)
        cfg.update({k: MODEL_CFG[k] for k in (
            "HIDDEN_DIM", "FFN_DIM", "NUM_ENC_LAYERS", "NUM_DEC_LAYERS",
            "NUM_DET_QUERIES", "TRACK_SLOTS")},
            WINDOW_SIZE=4, NUM_WORKERS=1)
        return cfg
    return base_config


@pytest.fixture(scope="module")
def campaign(tmp_path_factory, one_torch_thread):  # noqa: F811
    """deformable, then windowed_transplant from its @teacher, 1 epoch,
    through ``run_variant`` on the CPU; the captured ``train`` calls."""
    w = str(tmp_path_factory.mktemp("campaign"))
    calls = []
    orig_train = train_module.train

    def captured(config, device="cuda"):
        run = orig_train(config, device)
        calls.append((dict(config), run.pretrain, dict(run.states)))
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fe, "H", TINY_HW[0])
        mp.setattr(fe, "W", TINY_HW[1])
        mp.setattr(fe, "base_config", _tiny_base_config(fe.base_config))
        mp.setattr(train_module, "train", captured)
        root = os.path.join(w, "data")
        for split, seed in (("train", 3), ("val", 99)):
            fe.make_synvalue_v3(root, split, 2, TINY_FRAMES, seed)
        got = {name: fe.run_variant(root, w, name, 1, 42, "cpu")
               for name in ("deformable", "windowed_transplant")}
        reused = fe.run_variant(root, w, "windowed_transplant", 1, 42, "cpu")
        n_calls = len(calls)
        os.remove(os.path.join(fe.run_dir(w, "windowed_transplant", 42),
                               "val", "checkpoint_0_metrics.json"))
        resumed = fe.run_variant(root, w, "windowed_transplant", 1, 42,
                                 "cpu")
        with pytest.raises(FileNotFoundError, match="deformable seed-42"):
            fe.run_variant(root, str(tmp_path_factory.mktemp("empty")),
                           "hybrid_transplant", 1, 42, "cpu")
    return {"workdir": w, "metrics": got, "reused": reused,
            "resumed": resumed, "calls": calls, "n_calls": n_calls}


def test_tiny_campaign_scores_each_run(campaign):
    w = campaign["workdir"]
    for name, metrics in campaign["metrics"].items():
        path = os.path.join(fe.run_dir(w, name, 42), "val",
                            "checkpoint_0_metrics.json")
        assert os.path.isfile(path)
        assert set(metrics) == set(fe.SUMMARY)
        assert metrics == fe.metrics_of(w, name, 42, 1)
        assert os.path.isfile(os.path.join(fe.run_dir(w, name, 42),
                                           "checkpoint_0.pth"))
    (cfg_d, pre_d, _), (cfg_w, _, _) = campaign["calls"][:2]
    assert cfg_d["ENCODER_TYPE"] == "deformable" and pre_d is None
    assert cfg_w["ENCODER_TYPE"] == "windowed"
    assert cfg_w["PRETRAINED_MODEL"] == fe.teacher_ckpt(w, 1)


def test_tiny_campaign_transplant_merge_counts(campaign):
    cfg, stats, _ = campaign["calls"][1]
    teacher = torch.load(cfg["PRETRAINED_MODEL"], map_location="cpu",
                         weights_only=True)["model"]
    enc = sum(train_module._units(k) for k in teacher
              if k.startswith("transformer.encoder."))
    rest = sum(train_module._units(k) for k in teacher
               if not k.startswith("transformer.encoder.")
               and not train_module._HEAD_ALIAS.match(k))
    assert enc > 0 and rest > 0
    assert stats == {"loaded": rest, "shape_mismatch": 0,
                     "encoder_skipped": enc}


def test_tiny_campaign_reuses_and_resumes(campaign):
    assert campaign["n_calls"] == 2            # the second call trained none
    assert campaign["reused"] == campaign["metrics"]["windowed_transplant"]
    cfg, _, states = campaign["calls"][2]
    assert cfg["RESUME"] == os.path.join(
        fe.run_dir(campaign["workdir"], "windowed_transplant", 42),
        "checkpoint_0.pth")
    assert states["start_epoch"] == 1          # nothing left to train
    assert campaign["resumed"] == campaign["metrics"]["windowed_transplant"]


def test_epoch_iterations_count_the_datasets_clips(campaign):
    """Each epoch's clip length and clip count of ``base_config``'s
    schedule, against the port's training dataset on the tiny world (its
    sequences' annotated spans read from the dataset's boxes)."""
    from memotr_tpu_torch.data import build_dataset
    root = os.path.join(campaign["workdir"], "data")
    for epochs in (1, 4):
        dataset = build_dataset(fe.base_config(root, "", "deformable",
                                               epochs), split="train")
        spans = [max(g) - min(g) + 1 for g in dataset.gts.values()]
        assert len(spans) == 2 and max(spans) <= TINY_FRAMES
        got = []
        for epoch in range(epochs):
            dataset.set_epoch(epoch)
            got.append((len(dataset.get(0)["imgs"]), len(dataset)))
        assert fe.epoch_iterations(epochs, spans) == got
    assert fe.epoch_iterations(10) == [(2, 760)] * 5 + [(3, 752)] * 5


def _campaign_script():
    spec = importlib.util.spec_from_file_location(
        "campaign_h100", os.path.join(ROOT, "scripts", "campaign_h100.py"))
    ch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ch)
    return ch


def test_campaign_runs_go_through_the_tools_launch(tmp_path, monkeypatch):
    """``scripts/campaign_h100.py`` starts its runs at once through
    ``flagship_eval.launch`` with the tool's ``run_timeout``: a run killed
    at the timeout is recorded as such, and none starts under
    ``MIN_RUN_WINDOW`` to the hard stop."""
    ch = _campaign_script()
    launched = []

    def fake_launch(workdir, epochs, name, seed, device, timeout, log):
        launched.append((name, seed, device, timeout))
        log.write(json.dumps({"run": f"{name}_s{seed}", "metrics": None})
                  + "\n")
        if seed == 43:
            raise subprocess.TimeoutExpired("flagship_eval", timeout)
        return 0

    monkeypatch.setattr(fe, "launch", fake_launch)
    done, now = {}, time.time()
    ch.run_all([("deformable_w256", 42), ("deformable_w256", 43)],
               str(tmp_path), 10, str(tmp_path), now + 1000, ch.Sampler(),
               done)
    assert sorted(launched)[0][:3] == ("deformable_w256", 42, "cuda")
    assert all(900 < t <= 1000 for *_, t in launched)
    assert done["deformable_w256_s42"]["rc"] == 0
    assert done["deformable_w256_s43"]["rc"] == "killed at the hard stop"
    done.clear()
    ch.run_all([("deformable_w256", 44)], str(tmp_path), 10, str(tmp_path),
               time.time() + fe.MIN_RUN_WINDOW / 2, ch.Sampler(), done)
    assert done == {} and len(launched) == 2


def test_teacher_pack_round_trip(tmp_path):
    """``scripts/campaign_h100.py`` carries a teacher between machines in
    bfloat16: unpacked, every float tensor equals the original rounded to
    bfloat16, and the other tensors and the states are unchanged."""
    ch = _campaign_script()
    g = torch.Generator().manual_seed(0)
    model = {"transformer.encoder.w": torch.randn(5, 7, generator=g),
             "backbone.w": torch.randn(3, 4, 4, generator=g) * 1e-3,
             "backbone.bn.num_batches_tracked": torch.tensor(7),
             "head.b": torch.randn(11, generator=g) * 1e3}
    states = {"start_epoch": 10, "global_iters": 7560}
    torch.save({"model": model, "states": states, "optimizer": {}},
               str(tmp_path / "t.pth"))
    sizes = ch.pack_teacher(str(tmp_path / "t.pth"),
                            str(tmp_path / "t.bf16"))
    assert sizes["packed_mib"] < sizes["float32_mib"]
    ch.unpack_teacher(str(tmp_path / "t.bf16"), str(tmp_path / "u" / "t.pth"))
    got = torch.load(str(tmp_path / "u" / "t.pth"), weights_only=True)
    assert got["states"] == states
    assert set(got["model"]) == set(model)
    for k, v in got["model"].items():
        want = model[k].to(torch.bfloat16).float() \
            if model[k].is_floating_point() else model[k]
        assert v.dtype == model[k].dtype and torch.equal(v, want), k
