"""The port's ``train()`` against the JAX package's (float32, CPU).

One DanceTrack video of 3 JPEG frames (72x128), clips of 2 frames: 2
clips, so 2 steps an epoch, on a fixed 128x128 canvas at short sides 64/72,
one worker, TP/FP rates 0; the tiny deformable MeMOTR of the parity tests
at 1 encoder and 2 decoder layers, its weights from one seeded port model
written as a reference ``.pth`` and given to both as ``PRETRAINED_MODEL``.
JAX's ``train()`` (one epoch; its train step, compiled at XLA's lowest
optimization level, is this file's one JAX compile, and its parameter
init is traced for shapes only, since the ``.pth`` loads every tensor)
and the port's ``train(..., device="cpu")`` (two epochs) are compared
on:

- the pretrain-merge counts each prints (loaded, shape-mismatched, encoder
  skipped);
- the iteration-0 losses of ``scalars.jsonl`` (rtol 1e-4, float32 sums in
  another order through two frames);
- the parameters of the epoch-0 checkpoint (JAX's Orbax checkpoint read
  with ``orbax_io.load_checkpoint`` and mapped onto port names by
  ``state_dict_from_jax``), by the rule of
  ``test_torch_train_step.py::test_parameters_after_one_step_match_jax``
  applied per step, to every trainable element: within 0.1 lr a step.
  The rule asks it where each step's gradient is at least 1e-6; at this
  size the other elements hold to it too (measured: 0.0015 lr a step where
  every step's |g| >= 1e-6, 0.0093 lr a step elsewhere).  Frozen
  parameters unchanged;
- the progress states (start epoch, global iterations).

Port only: resume from ``checkpoint_0`` gives the unbroken run's
``checkpoint_1`` bit for bit; a windowed model skips exactly the
deformable checkpoint's encoder tensors; a port checkpoint loads back with
every tensor; the entry points raise without a card unless asked for the
CPU, and on the options not ported.
"""
import json
import os
import random
import re
from contextlib import redirect_stdout
from io import StringIO

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch
import yaml

import memotr_tpu.engine.train as jax_train_module
from memotr_tpu.checkpoint.orbax_io import load_checkpoint as orbax_load
from memotr_tpu_torch.checkpoint.convert import state_dict_from_jax
from memotr_tpu_torch.checkpoint.files import load_checkpoint
from memotr_tpu_torch.engine import train as port_train
from memotr_tpu_torch.engine.trainer import param_group_label
from memotr_tpu_torch.log.logger import Logger
from memotr_tpu_torch.main import main
from memotr_tpu_torch.models.memotr import build_model
from test_torch_port_weights import randomize_
from test_torch_train_step import CFG
from test_torch_train_windowed_step import FAST_COMPILE

MERGE = re.compile(r"Pretrain merge: (\d+) tensors loaded, (\d+) "
                   r"shape-mismatched, (\d+) encoder leaves skipped\.")
# the train-step tests' tiny model at 1 encoder and 2 decoder layers (half
# of JAX's trace and compile time)
MODEL_CFG = dict(CFG, NUM_ENC_LAYERS=1, NUM_DEC_LAYERS=2, AUX_LOSS_WEIGHT=[1.0])
LOSSES = ("label_focal_loss", "box_l1_loss", "box_giou_loss",
          "aux_label_focal_loss", "aux_box_l1_loss", "aux_box_giou_loss",
          "total_loss", "n_gts")


def _tree(root):
    rng = np.random.default_rng(1)
    vdir = os.path.join(root, "DanceTrack", "train", "v1")
    os.makedirs(os.path.join(vdir, "img1"))
    os.makedirs(os.path.join(vdir, "gt"))
    lines = []
    for t in range(1, 4):
        PIL.Image.fromarray(rng.integers(30, 200, (72, 128, 3), np.uint8)) \
            .save(os.path.join(vdir, "img1", f"{t:08d}.jpg"), quality=95)
        lines += [f"{t},{o + 1},{8 + 30 * o + 2 * t},{10 + 6 * o},26,34,1,1,1\n"
                  for o in range(3)]
    with open(os.path.join(vdir, "gt", "gt.txt"), "w") as f:
        f.writelines(lines)


def _pretrained_model():
    """A seeded port model whose detections fire (as the train-step
    tests' ``_port_model``), at this file's depth."""
    torch.manual_seed(0)
    model = randomize_(build_model(MODEL_CFG), 11)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                mod.weight.add_(1.0)
        model.det_query_embed.mul_(12.5)
        model.det_anchor.mul_(12.5)
    return model


def _config(tmp, out, **kw):
    cfg = dict(MODEL_CFG, MODE="train", SEED=42, BATCH_SIZE=1, NUM_WORKERS=1, EPOCHS=2,
               SAMPLE_STEPS=[100], SAMPLE_LENGTHS=[2], SAMPLE_INTERVALS=[1],
               SAMPLE_MODES=["random_interval"], FIXED_TRAIN_CANVAS=[128, 128],
               TRAIN_SHORT_SIDES=[64, 72], TRAIN_MAX_SIZE=128,
               COCO_SIZE=False, OVERFLOW_BBOX=False, REVERSE_CLIP=0.0,
               MESH_DEVICES=1, ACCUMULATION_STEPS=1, NO_GRAD_FRAMES=None,
               ONLY_TRAIN_QUERY_UPDATER_AFTER=20, MULTI_CHECKPOINT=False,
               DATA_ROOT=str(tmp / "data"),
               PRETRAINED_MODEL=str(tmp / "pretrained.pth"),
               OUTPUTS_DIR=str(tmp / out), RESUME=None, VISUALIZE=False)
    cfg.update(kw)
    return cfg


def _merge_line(text):
    return [tuple(map(int, m)) for m in MERGE.findall(text)]


def _fast_make_train_step(*args, **kw):
    """JAX's jitted train step, compiled once with XLA's LLVM back end at
    its lowest optimization level (test-time compile speed only)."""
    jitted = jax_make_train_step(*args, **kw)
    compiled = []

    def step(*a):
        if not compiled:
            compiled.append(jitted.lower(*a).compile(
                compiler_options=FAST_COMPILE))
        return compiled[0](*a)
    return step


def _shaped_init_params(config, model, updater, seed=0):
    """Zero parameter trees of ``init_model_params``'s shapes, traced and
    not compiled: ``PRETRAINED_MODEL`` then loads every one of them (the
    merge counts show it)."""
    shapes = jax.eval_shape(
        lambda: jax_init_model_params(config, model, updater, seed))
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                  shapes)


jax_make_train_step = jax_train_module.make_train_step
jax_init_model_params = jax_train_module.init_model_params


def _jax_train(config):
    jax_train_module.make_train_step = _fast_make_train_step
    jax_train_module.init_model_params = _shaped_init_params
    try:
        return jax_train_module.train(config)
    finally:
        jax_train_module.make_train_step = jax_make_train_step
        jax_train_module.init_model_params = jax_init_model_params


def _scalars(out):
    with open(os.path.join(out, "train", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU steps on one thread: the suite runs six test
    processes on the host's cores, and torch's thread pool in each of
    them oversubscribes it (a 3 s resume took 62 s there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):
    tmp = tmp_path_factory.mktemp("train_loop")
    _tree(str(tmp / "data"))
    torch.save({"model": _pretrained_model().state_dict()},
               str(tmp / "pretrained.pth"))
    out = {}
    for name, fn in (("jax", lambda: _jax_train(_config(tmp, "jax",
                                                        EPOCHS=1))),
                     ("port", lambda: port_train.train(_config(tmp, "port"),
                                                       device="cpu"))):
        buf = StringIO()
        with redirect_stdout(buf):
            out[name] = fn()
        out[name + "_log"] = buf.getvalue()
    out["tmp"] = tmp
    return out


def test_pretrain_merge_counts_match_jax(runs):
    jax_counts = _merge_line(runs["jax_log"])
    port_counts = _merge_line(runs["port_log"])
    assert port_counts == jax_counts and len(port_counts) == 1
    loaded, mismatched, skipped = port_counts[0]
    assert loaded > 400 and mismatched == skipped == 0
    assert runs["port"].pretrain == dict(zip(
        ("loaded", "shape_mismatch", "encoder_skipped"), port_counts[0]))


def test_iteration0_losses_match_jax(runs):
    tmp = runs["tmp"]
    want = _scalars(tmp / "jax")[0]
    got = _scalars(tmp / "port")[0]
    assert got["step"] == want["step"] == 0
    for k in LOSSES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    frame_keys = [k for k in want if k.startswith("frame")]
    assert frame_keys
    for k in frame_keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert np.isfinite(got["total_loss"]) and got["n_gts"] == 6


def test_epoch_checkpoint_parameters_match_jax(runs):
    tmp = runs["tmp"]
    restored = orbax_load(str(tmp / "jax" / "checkpoint_0"))
    assert {k: int(v) for k, v in restored["states"].items()} == \
        {"start_epoch": 1, "global_iters": 2}
    want = {k: v.numpy() for k, v in state_dict_from_jax(
        restored["params"]["model"], restored["params"]["updater"],
        restored["frozen"]).items()}
    ckpt = load_checkpoint(str(tmp / "port" / "checkpoint_0.pth"))
    assert ckpt["states"] == {"start_epoch": 1, "global_iters": 2}
    got = {k: v.numpy() for k, v in ckpt["model"].items()}
    before = torch.load(str(tmp / "pretrained.pth"), weights_only=True)["model"]
    assert set(got) == set(want)
    lr = {"backbone": CFG["LR_BACKBONE"], "points": CFG["LR_POINTS"],
          "query_updater": CFG["LR"], "base": CFG["LR"], "frozen": 0.0}
    steps = 2                              # the epoch-0 steps
    params = dict(build_model(MODEL_CFG).named_parameters(
        remove_duplicate=False))
    for k, w in want.items():
        if k not in params or param_group_label(k) == "frozen":
            np.testing.assert_array_equal(got[k], before[k].numpy(),
                                          err_msg=k)
            np.testing.assert_array_equal(w, before[k].numpy(), err_msg=k)
            continue
        step_lr = lr[param_group_label(k)]
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=0.1 * step_lr * steps, err_msg=k)
        assert not np.array_equal(got[k], before[k].numpy()), k


def test_resume_equals_the_unbroken_run(runs):
    tmp = runs["tmp"]
    cfg = _config(tmp, "resumed",
                  RESUME=str(tmp / "port" / "checkpoint_0.pth"))
    run = port_train.train(cfg, device="cpu")
    assert run.states == {"start_epoch": 2, "global_iters": 4}
    assert len(run.step_seconds) == 2
    assert not os.path.exists(tmp / "resumed" / "checkpoint_0.pth")
    got = load_checkpoint(str(tmp / "resumed" / "checkpoint_1.pth"))
    want = load_checkpoint(str(tmp / "port" / "checkpoint_1.pth"))
    assert got["states"] == want["states"] == \
        {"start_epoch": 2, "global_iters": 4}
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for a, b in zip(got["optimizer"]["state"].values(),
                    want["optimizer"]["state"].values()):
        for k in b:
            assert torch.equal(a[k], b[k]), k
    got, want = _scalars(tmp / "resumed")[0], _scalars(tmp / "port")[1]
    assert got["step"] == want["step"] == 2
    for k in LOSSES:
        assert got[k] == want[k], k


def _loaded(config):
    model = build_model(config)
    stats = port_train.load_pretrained(config, model, Logger(
        os.path.join(config["OUTPUTS_DIR"], "train")))
    return model, stats


def test_windowed_model_skips_exactly_the_encoder(runs):
    tmp = runs["tmp"]
    sd = torch.load(str(tmp / "pretrained.pth"), weights_only=True)["model"]
    encoder = [k for k in sd if k.startswith("transformer.encoder.")]
    cfg = _config(tmp, "windowed", ENCODER_TYPE="windowed", NUM_ENC_LAYERS=1)
    torch.manual_seed(0)
    fresh = build_model(cfg).state_dict()
    torch.manual_seed(0)
    model, stats = _loaded(cfg)
    assert stats["encoder_skipped"] == len(encoder) > 0
    assert stats["shape_mismatch"] == 0
    for k, v in model.state_dict().items():
        want = fresh[k] if k.startswith("transformer.encoder.") else sd[k]
        assert torch.equal(v, want), k
    # told not to skip, the deformable encoder's names do not fit this model
    _, stats = _loaded(dict(cfg, PRETRAIN_SKIP_ENCODER=False))
    assert stats["encoder_skipped"] == 0


def test_port_checkpoint_loads_back_whole(runs):
    tmp = runs["tmp"]
    path = str(tmp / "port" / "checkpoint_1.pth")
    model, stats = _loaded(_config(tmp, "reload", PRETRAINED_MODEL=path))
    sd = load_checkpoint(path)["model"]
    aliases = [k for k in sd if port_train._HEAD_ALIAS.match(k)]
    assert stats == {"loaded": sum(port_train._units(k) for k in sd)
                     - len(aliases), "shape_mismatch": 0,
                     "encoder_skipped": 0}
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def _write_yaml(tmp):
    path = tmp / "cfg.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(_config(tmp, "cli"), f)
    return ["--config-path", str(path)]


def test_entry_points_raise_without_a_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.train(_config(tmp_path, "out"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(_write_yaml(tmp_path) + ["--mode", "train"])
    assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("args, error, match", [
    (["--mode", "eval", "--multi-host"], RuntimeError,
     "--multi-host needs torchrun"),
    (["--mode", "train", "--multi-host"], RuntimeError,
     "--multi-host needs torchrun"),
    (["--mode", "eval", "--mesh-devices", "2"], NotImplementedError,
     "--multi-host"),
    (["--mode", "train", "--mesh-devices", "2"], NotImplementedError,
     "--multi-host"),
    (["--mode", "train", "--token-shard-axis", "seq"], NotImplementedError,
     "TPU-only"),
    (["--mode", "train", "--mesh-seq-devices", "2"], NotImplementedError,
     "--multi-host"),
])
def test_options_not_ported_raise(tmp_path, args, error, match):
    """``--multi-host`` outside torchrun's environment raises an error that
    names it; the TPU's in-process mesh keys raise one that names the
    multi-process route, and token sharding is TPU-only.  Nothing is
    written."""
    with pytest.raises(error, match=match):
        main(_write_yaml(tmp_path) + args + ["--device", "cpu"])
    assert not os.path.exists(tmp_path / "cli")


def test_seed_draws_match_jax():
    from memotr_tpu.utils.misc import set_seed as jax_set_seed
    from memotr_tpu_torch.utils.misc import set_seed
    draws = []
    for fn in (jax_set_seed, set_seed):
        assert fn(5, rank=2) == 7
        draws.append((random.random(), np.random.rand(),
                      os.environ["PYTHONHASHSEED"]))
    assert draws[0] == draws[1]
