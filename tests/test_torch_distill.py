"""Teacher->student distillation (``DISTILL_TEACHER``) in the port against
the JAX package (float32, CPU).

- ``distill_frame_losses`` on seeded arrays (padded memory tokens
  included) against JAX's: the three terms to 1e-6 relative.
- One clip loss, the JAX package's own pairing
  (tests/test_transplant_distill.py): the tiny windowed student of
  tests/test_torch_train_windowed_step.py learns from a tiny deformable
  teacher (1 encoder and 2 decoder layers, the same width and detection
  queries), on that file's 2-frame B=2 clip with ``NO_GRAD_FRAMES`` 1, so
  frame 0 runs without gradient and its distillation terms still count,
  as constants; the term weights are not 1 (0.5, 2, 1.5).  The port's
  ``clip_loss(..., distill=...)`` against JAX's ``clip_loss(...,
  distill=..., teacher_params=...)`` under ``jax.value_and_grad``, at the
  tolerances test_torch_train_step.py states and
  test_torch_train_windowed_step.py uses: every loss, log and
  distillation term (rtol 1e-4: float32 sums in another order through two
  frames), and every gradient, per leaf as ``_assert_grads_close`` holds
  them (JAX's frozen-group gradients zeroed, as its train step does).
  Every score and IoU a track-selection decision compares with a
  threshold clears it by at least 1e-3.  The teacher gets no gradient.
  One JAX compile, in the module fixture, at XLA's lowest optimization
  level (``compiled``).
- ``train()`` through the port's CLI with ``DISTILL_TEACHER``: the terms
  in ``scalars.jsonl``, finite and above 0; the teacher unchanged, out of
  the optimizer and out of the student's checkpoint; a ``HIDDEN_DIM``
  mismatch, a directory and a checkpoint missing a key each raise.
"""
import copy
import json
import os
from contextlib import redirect_stdout
from io import StringIO

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from memotr_tpu.engine.trainer import clip_loss as jax_clip_loss
from memotr_tpu.engine.trainer import \
    distill_frame_losses as jax_distill_frame_losses
from memotr_tpu.engine.trainer import label_tree, zero_frozen_grads
from memotr_tpu.engine.trainer import static_config as jax_static_config
from memotr_tpu.models.criterion import build_criterion as jax_criterion
from memotr_tpu.models.memotr import build_model as jax_build_model
from memotr_tpu.models.query_updater import build_query_updater
from memotr_tpu_torch.checkpoint.files import load_checkpoint, save_checkpoint
from memotr_tpu_torch.config import dict_to_yaml
from memotr_tpu_torch.engine import trainer as port_trainer
from memotr_tpu_torch.engine.trainer import (BATCH_KEYS, DISTILL_KEYS,
                                             clip_loss, distill_frame_losses,
                                             static_config)
from memotr_tpu_torch.main import main
from memotr_tpu_torch.models.criterion import build_criterion
from test_torch_train_loop import _config as loop_config
from test_torch_train_loop import _pretrained_model, _tree
from test_torch_train_loop import one_torch_thread  # noqa: F401
from test_torch_train_loop import MODEL_CFG as LOOP_CFG
from test_torch_train_step import (CFG as TRAIN_CFG, MARGIN,
                                   _assert_grads_close, _batch)
from test_torch_train_windowed_step import CFG as WINDOWED_CFG
from test_torch_train_windowed_step import (compiled, port_grads, port_named,
                                            record_margins)
from test_torch_windowed_slice import jax_trees, port_model

STUDENT_CFG = dict(WINDOWED_CFG, NO_GRAD_FRAMES=1)
TEACHER_CFG = dict(TRAIN_CFG, NUM_ENC_LAYERS=1, NUM_DEC_LAYERS=2,
                   AUX_LOSS_WEIGHT=[1.0])
WEIGHTS = {"distill_memory": 0.5, "distill_logit": 2.0, "distill_box": 1.5}


def test_distill_frame_losses_match_jax():
    rng = np.random.default_rng(4)
    b, s, c, n, nd = 2, 40, 16, 12, 9
    mask = np.zeros((b, s), bool)
    mask[1, 31:] = True                     # padded tokens of one image
    arrays = {
        side: {"memory": rng.normal(size=(b, s, c)).astype(np.float32),
               "memory_mask": mask,
               "pred_logits": rng.normal(size=(b, n, 1)).astype(np.float32),
               "pred_boxes": rng.uniform(size=(b, n, 4)).astype(np.float32)}
        for side in ("student", "teacher")}
    got = distill_frame_losses(
        *({k: torch.from_numpy(v) for k, v in arrays[side].items()}
          for side in ("student", "teacher")), nd)
    want = jax_distill_frame_losses(
        *({k: jnp.asarray(v) for k, v in arrays[side].items()}
          for side in ("student", "teacher")), nd)
    assert set(got) == set(want) == set(DISTILL_KEYS)
    for k in DISTILL_KEYS:
        assert float(got[k]) > 0
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    # the padded tokens do not count
    moved = copy.deepcopy(arrays)
    moved["student"]["memory"][1, 31:] += 100.0
    again = distill_frame_losses(
        *({k: torch.from_numpy(v) for k, v in moved[side].items()}
          for side in ("student", "teacher")), nd)
    assert float(again["distill_memory"]) == float(got["distill_memory"])


@pytest.fixture(scope="module")
def runs():
    s_params, s_uparams, s_frozen = jax_trees(STUDENT_CFG, seed=21)
    t_params, t_uparams, t_frozen = jax_trees(TEACHER_CFG, seed=5)
    student = port_model(STUDENT_CFG, (s_params, s_uparams, s_frozen))
    teacher = port_model(TEACHER_CFG, (t_params, t_uparams, t_frozen))
    teacher_before = copy.deepcopy(teacher.state_dict())
    batch = _batch(student)

    jmodel = jax_build_model(STUDENT_CFG)
    cs = jax_static_config(STUDENT_CFG, jmodel)
    assert cs["no_grad_frames"] == 1
    distill = {"model": jax_build_model(TEACHER_CFG), "weights": WEIGHTS}
    jupd, jcrit = build_query_updater(STUDENT_CFG), jax_criterion(STUDENT_CFG)

    def loss(trainable, frozen, jbatch, rng, teacher_params):
        return jax_clip_loss(trainable, frozen, jmodel, jupd, jcrit, jbatch,
                             rng, cs, distill=distill,
                             teacher_params=teacher_params)

    trainable = {"model": s_params, "updater": s_uparams}
    (_, jlogs), jgrads = compiled(
        jax.jit(jax.value_and_grad(loss, has_aux=True)), trainable,
        {"frozen": s_frozen}, {k: jnp.asarray(batch[k]) for k in BATCH_KEYS},
        jax.random.PRNGKey(0), {"params": t_params, "frozen": t_frozen})
    jgrads = zero_frozen_grads(jgrads, label_tree(trainable))

    pcs = static_config(STUDENT_CFG, student)
    assert pcs["no_grad_frames"] == 1
    teacher.requires_grad_(False)
    margins = []
    orig, recording = record_margins(margins)
    port_trainer.train_frame_step = recording
    try:
        total, logs = clip_loss(
            student.train(), build_criterion(STUDENT_CFG),
            {k: torch.as_tensor(batch[k]) for k in BATCH_KEYS},
            torch.Generator().manual_seed(0), pcs,
            distill={"model": teacher, "weights": WEIGHTS})
        total.backward()
    finally:
        port_trainer.train_frame_step = orig
    return {"logs": logs, "jlogs": jlogs, "grads": port_grads(student),
            "jgrads": port_named((jgrads["model"], jgrads["updater"]),
                                 s_frozen),
            "margins": margins, "teacher": teacher,
            "teacher_before": teacher_before}


def test_decisions_clear_thresholds(runs):
    assert min(runs["margins"]) >= MARGIN


def test_distill_terms_match_jax(runs):
    for k in DISTILL_KEYS:
        got, want = float(runs["logs"][k]), float(runs["jlogs"][k])
        assert np.isfinite(got) and got > 0, k
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=k)


def test_losses_and_logs_match_jax(runs):
    """Every log, ``total_loss`` with the weighted terms of both frames
    (frame 0's, from its no-grad forward, included)."""
    logs, jlogs = runs["logs"], runs["jlogs"]
    assert set(logs) == set(jlogs), set(logs) ^ set(jlogs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_every_gradient_matches_jax(runs):
    want = {n: runs["jgrads"][n] for n in runs["grads"]}
    live = _assert_grads_close(runs["grads"], want)
    # frame 0 runs without gradient and frame 1 has no postprocess: the
    # query updater gets none
    updater = [k for k in want if k.startswith("query_updater.")]
    assert updater and all(not np.any(want[k]) for k in updater)
    assert live > 0.8 * (len(want) - len(updater))


def test_teacher_gets_no_gradient(runs):
    for name, p in runs["teacher"].named_parameters():
        assert p.grad is None, name
    for k, v in runs["teacher"].state_dict().items():
        assert torch.equal(v, runs["teacher_before"][k]), k


# ------------------------------------------------------ train() with a teacher
def _teacher_dir(tmp, **cfg_changes):
    """A teacher as the port's training leaves it: ``train/config.yaml``
    and an epoch checkpoint (the deformable model of
    tests/test_torch_train_loop.py)."""
    tdir = tmp / "teacher"
    os.makedirs(tdir / "train")
    dict_to_yaml(dict(LOOP_CFG, **cfg_changes),
                 str(tdir / "train" / "config.yaml"))
    path = str(tdir / "checkpoint_0.pth")
    save_checkpoint(path, _pretrained_model(),
                    states={"start_epoch": 1, "global_iters": 2})
    return path


def _argv(tmp, teacher, out="distilled"):
    cfg = loop_config(tmp, out, ENCODER_TYPE="windowed", WINDOW_SIZE=4,
                      EPOCHS=1, PRETRAINED_MODEL=None,
                      DISTILL_TEACHER=teacher, DISTILL_WEIGHT_MEMORY=0.5,
                      DISTILL_WEIGHT_LOGIT=2.0, DISTILL_WEIGHT_BOX=1.5)
    path = tmp / f"{out}.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return ["--config-path", str(path), "--mode", "train", "--device", "cpu"]


@pytest.fixture(scope="module")
def distilled(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distill")
    _tree(str(tmp / "data"))
    teacher = _teacher_dir(tmp)
    out = StringIO()
    with redirect_stdout(out):
        run = main(_argv(tmp, teacher))
    return tmp, teacher, run, out.getvalue()


def test_train_logs_finite_distill_terms(distilled):
    tmp, teacher, run, stdout = distilled
    with open(tmp / "distilled" / "train" / "scalars.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert recs
    for rec in recs:
        for k in DISTILL_KEYS:
            assert np.isfinite(rec[k]) and rec[k] > 0, (k, rec)
    assert f"Distillation: teacher={teacher} (deformable encoder), " \
        f"weights={WEIGHTS}" in stdout
    assert run.trainer.distill["weights"] == WEIGHTS


def test_teacher_untouched_and_outside_the_student(distilled):
    tmp, teacher, run, _ = distilled
    t_model = run.trainer.distill["model"]
    assert not t_model.training
    saved = load_checkpoint(teacher)["model"]
    for k, v in t_model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    for p in t_model.parameters():
        assert not p.requires_grad and p.grad is None
    in_opt = {id(p) for g in run.trainer.optimizer.param_groups
              for p in g["params"]}
    assert not in_opt & {id(p) for p in t_model.parameters()}
    ckpt = load_checkpoint(str(tmp / "distilled" / "checkpoint_0.pth"))
    assert set(ckpt["model"]) == set(run.trainer.model.state_dict())
    assert not any(k.startswith("transformer.encoder.layers.0.self_attn")
                   for k in ckpt["model"])      # the teacher's encoder


def test_hidden_dim_mismatch_raises(tmp_path):
    teacher = _teacher_dir(tmp_path, HIDDEN_DIM=32)
    with pytest.raises(ValueError, match="HIDDEN_DIM 32"):
        main(_argv(tmp_path, teacher))


def test_directory_teacher_raises(tmp_path):
    teacher = tmp_path / "teacher" / "checkpoint_0"
    os.makedirs(teacher)
    with pytest.raises(ValueError, match="is a directory"):
        main(_argv(tmp_path, str(teacher)))


def test_teacher_missing_a_key_raises(tmp_path):
    teacher = _teacher_dir(tmp_path)
    ckpt = load_checkpoint(teacher)
    del ckpt["model"]["det_anchor"]
    torch.save(ckpt, teacher)
    with pytest.raises(RuntimeError, match="det_anchor"):
        main(_argv(tmp_path, teacher))
