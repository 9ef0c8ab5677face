"""The port's training step of the windowed MeMOTR against the JAX
package's (float32, CPU).

The tiny windowed model of tests/test_torch_windowed_slice.py (2 windowed
encoder layers, one window and one grid, window 4, LePE, bottom-up fusion,
continuous position bias; 30 detection queries, 4 track slots) with the
training keys of tests/test_torch_train_step.py and 2 decoder layers (one
auxiliary loss; the third layer of test_torch_train_step.py's model would
add a sixth of JAX's compile and nothing windowed), its JAX
trees filled from a numpy seed and loaded into the port through
``state_dict_from_jax``.  The 2-frame B=2 clip of test_torch_train_step.py
(GTs on the model's own detections, the second row padded from row 56)
goes through the port's ``Trainer`` (CPU, so the plain window attention)
and through JAX's ``make_train_step``, whose windowed encoder takes its
default XLA route (``WINDOWED_ATTN_IMPL``; the same math as the fused
route the port mirrors).

Compared, with the tolerances test_torch_train_step.py states: every loss
and log (rtol 1e-4); the gradient norm before clipping (rtol 1e-4); every
parameter's clipped gradient (JAX's read back from Adam's first moment and
mapped onto port names with ``state_dict_from_jax``), per leaf as
``_assert_grads_close`` holds them; the parameters after one clipped AdamW
step.  Every score and IoU a track-selection decision compares with a
threshold clears it by at least 1e-3.  The windowed encoder's own
parameters (CPB MLPs, LePE, the attention projections, the fusion mixes)
must all carry a live gradient.  One JAX compile, in the module fixture,
with XLA's LLVM back end at its lowest optimization level (a third less
compile time; the same HLO).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memotr_tpu.engine.trainer import init_train_state, make_train_step
from memotr_tpu_torch.checkpoint.convert import state_dict_from_jax
from memotr_tpu_torch.engine import trainer as port_trainer
from memotr_tpu_torch.engine.trainer import BATCH_KEYS, Trainer
from memotr_tpu_torch.models import frame_step
from test_torch_train_step import one_torch_thread  # noqa: F401
from test_torch_train_step import (CFG as TRAIN_CFG, MARGIN, THRESH,
                                   _adam_mu, _assert_grads_close, _batch,
                                   _jax_lrs, _jax_setup)
from test_torch_windowed_slice import jax_trees, port_model

CFG = dict(TRAIN_CFG, ENCODER_TYPE="windowed", WINDOW_SIZE=4,
           NUM_DEC_LAYERS=2, AUX_LOSS_WEIGHT=[1.0])
# the windowed encoder's parameters, by a part of their port names
ENCODER_PARTS = ("cpb_mlp1", "cpb_mlp2", "lepe_dwconv", "win_attn.in_proj",
                 "win_attn.out_proj", "topdown_mix", "bottomup_mix",
                 "encoder.layers.0.norm1", "encoder.layers.1.linear2")
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def compiled(jitted, *args):
    """Run a jitted JAX function compiled with XLA's LLVM back end at its
    lowest optimization level (test-time compile speed only)."""
    return jitted.lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


def port_named(trees, frozen):
    """A port-named dict of numpy arrays from JAX trees (params, uparams),
    through ``state_dict_from_jax`` (``frozen``: the tree whose structure
    the frozen statistics take, zeroed)."""
    params, uparams = trees
    zeros = jax.tree_util.tree_map(np.zeros_like, frozen)
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                             jax.tree_util.tree_map(np.asarray, uparams),
                             zeros)
    return {k: v.numpy() for k, v in sd.items()}


def port_grads(model):
    """The port's gradients by parameter name (zeros where None)."""
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().numpy() for n, p in model.named_parameters()}


def trainable_names(model):
    return [n for n, p in model.named_parameters() if p.requires_grad]


def record_margins(margins):
    """A ``train_frame_step`` that records how far each selection decision
    lies from its threshold (as test_torch_train_step.py does), reading the
    scores from the step's own forward."""
    orig, forward = port_trainer.train_frame_step, frame_step.model_forward
    outs = []

    def recording_forward(*args):
        outs.append(forward(*args))
        return outs[-1]

    def step(model_, crit, images, mask, gt, state, *args, **kw):
        frame_step.model_forward = recording_forward
        try:
            losses, n_gts, st = orig(model_, crit, images, mask, gt, state,
                                     *args, **kw)
        finally:
            frame_step.model_forward = forward
        if kw["postprocess"]:
            logits = outs[-1]["pred_logits"].detach()
            scores = torch.sigmoid(logits[:, :crit.n_det, 0])
            margins.extend((scores - THRESH).abs().flatten().tolist())
            margins.extend((st.iou[st.mask] - THRESH).abs().tolist())
        return losses, n_gts, st
    return orig, step


@pytest.fixture(scope="module")
def runs():
    params, uparams, frozen = jax_trees(CFG, seed=21)
    model = port_model(CFG, (params, uparams, frozen))
    batch = _batch(model)
    jmodel, jupd, jcrit, opt, cs, labels, _ = _jax_setup(CFG, params,
                                                         uparams)
    step = make_train_step(jmodel, jupd, jcrit, opt, cs, labels)
    jstate, jlogs = compiled(step, init_train_state(params, uparams, opt),
                             {"frozen": frozen},
                             {k: jnp.asarray(batch[k]) for k in BATCH_KEYS},
                             jax.random.PRNGKey(0), _jax_lrs(CFG))
    mu = _adam_mu(jstate.opt_state)
    jgrads = port_named((jax.tree_util.tree_map(lambda m: m / 0.1,
                                                mu["model"]),
                         jax.tree_util.tree_map(lambda m: m / 0.1,
                                                mu["updater"])), frozen)
    jparams = port_named((jstate.params["model"], jstate.params["updater"]),
                         frozen)

    smodel = copy.deepcopy(model)
    margins = []
    orig, recording = record_margins(margins)
    port_trainer.train_frame_step = recording
    try:
        logs = Trainer(smodel, CFG, device="cpu").step(batch)
    finally:
        port_trainer.train_frame_step = orig
    names = trainable_names(smodel)
    return {"model": model, "smodel": smodel, "logs": logs, "jlogs": jlogs,
            "grads": port_grads(smodel), "jgrads": jgrads,
            "jparams": jparams, "margins": margins, "names": names}


def test_decisions_clear_thresholds(runs):
    assert min(runs["margins"]) >= MARGIN


def test_losses_and_logs_match_jax(runs):
    logs, jlogs = runs["logs"], runs["jlogs"]
    assert set(jlogs) - {"grad_norm"} <= set(logs), set(jlogs) ^ set(logs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert float(jlogs["grad_norm"]) > CFG["CLIP_MAX_NORM"]   # clipping on


def test_every_gradient_matches_jax(runs):
    want = {n: runs["jgrads"][n] for n in runs["grads"]}
    live = _assert_grads_close(runs["grads"], want)
    assert live > 0.8 * len(want)


def test_encoder_parameters_are_reached(runs):
    """Every trainable parameter got a gradient, and every windowed-encoder
    part a live one (the bias tables are rebuilt with gradient each step)."""
    smodel, grads = runs["smodel"], runs["grads"]
    assert runs["logs"]["params_without_grad"] == 0
    for part in ENCODER_PARTS:
        hit = [n for n in runs["names"] if part in n]
        assert hit, part
        for n in hit:
            assert np.abs(grads[n]).max() > 0, n
    for name, p in smodel.named_parameters():
        assert (p.grad is None) == (not p.requires_grad), name


def test_parameters_after_one_step_match_jax(runs):
    """AdamW's first step on the port's own clipped gradients, landing
    where JAX's does to 0.1 lr wherever |g| >= 1e-6, as
    test_torch_train_step.py states."""
    before = {n: p.detach().numpy()
              for n, p in runs["model"].named_parameters()}
    got = {n: p.detach().numpy() for n, p in runs["smodel"].named_parameters()}
    lrs = port_trainer.group_lrs(CFG, 0)
    for name in runs["names"]:
        lr = lrs[port_trainer.param_group_label(name)]
        g, jg = runs["grads"][name], runs["jgrads"][name]
        adamw = before[name] - lr * CFG["WEIGHT_DECAY"] * before[name] \
            - lr * g / (np.abs(g) + 1e-8)
        np.testing.assert_allclose(got[name], adamw, rtol=2.5e-7,
                                   atol=1e-3 * lr, err_msg=name)
        big = np.abs(jg) >= 1e-6
        np.testing.assert_allclose(got[name][big],
                                   runs["jparams"][name][big], rtol=0,
                                   atol=0.1 * lr, err_msg=name)
    np.testing.assert_allclose(float(runs["logs"]["grad_norm"]),
                               float(runs["jlogs"]["grad_norm"]), rtol=1e-4)


def test_windowed_names_take_jax_groups(runs):
    """The windowed encoder's parameters fall to "base", as JAX's
    ``label_tree`` gives (no backbone, points or updater name)."""
    for name in runs["names"]:
        if name.startswith("transformer.encoder."):
            assert port_trainer.param_group_label(name) == "base", name
