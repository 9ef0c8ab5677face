"""The port's training step against the JAX package's (float32, CPU).

A 2-frame clip, B=2, on the tiny deformable MeMOTR of the parity tests
(``TINY_CFG``: 2 encoder and 3 decoder layers, merge at layer 1, 30
detection queries, 4 track slots), the weights of one randomized port model
on both sides.  Frame 0's GTs sit on detections of the model (so their
newborn tracks keep their identities); in frame 1 one identity vanished,
two are tracked and one is newborn.  The port's ``Trainer`` (CPU) and the
JAX ``make_train_step`` take the same batch.

Compared: every loss and log (rtol 1e-4: float32 sums in another order
through two frames); every parameter's clipped gradient (the port's
``.grad`` after ``clip_grad_norm_``, converted by
``convert_torch_state_dict`` with zeros for the frozen stem and layer1;
JAX's read back from Adam's first moment, (1 - b1) x the clipped
gradient after one step), per leaf as ``_assert_grads_close`` states;
the gradient norm before clipping (rtol 1e-4); the parameters after that
AdamW step, with clipping engaged (as the last test states).  Every score and IoU a track-selection decision compares with a
threshold lies at least 1e-3 from it, so a flipped decision fails loudly.
Also: accumulation over 2 micro-batches against one step, frozen
parameters get no gradient, and the entry raises without a card unless
asked for the CPU.  ``NO_GRAD_FRAMES`` is in test_torch_train_nograd.py
(its own JAX compile, on its own test worker).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memotr_tpu.checkpoint.torch_convert import convert_torch_state_dict
from memotr_tpu.engine.trainer import group_lrs as jax_group_lrs
from memotr_tpu.engine.trainer import (init_train_state, label_tree,
                                       make_optimizer, make_train_step)
from memotr_tpu.engine.trainer import static_config as jax_static_config
from memotr_tpu.models.criterion import build_criterion as jax_criterion
from memotr_tpu.models.memotr import build_model as jax_build_model
from memotr_tpu.models.query_updater import build_query_updater
from memotr_tpu_torch.data.loader import collate_clips
from memotr_tpu_torch.engine import trainer as port_trainer
from memotr_tpu_torch.engine.trainer import BATCH_KEYS, Trainer
from memotr_tpu_torch.models.frame_step import model_forward
from memotr_tpu_torch.models.memotr import build_model
from memotr_tpu_torch.structures.track_state import TrackState
from test_torch_port_weights import HD, SLOTS, TINY_CFG, randomize_, to_jax_trees

CFG = dict(TINY_CFG, MATCH_COST_CLASS=2.0, MATCH_COST_BBOX=5.0,
           MATCH_COST_GIOU=2.0, LOSS_WEIGHT_FOCAL=2.0, LOSS_WEIGHT_L1=5.0,
           LOSS_WEIGHT_GIOU=2.0, AUX_LOSS=True, AUX_LOSS_WEIGHT=[1.0, 1.0],
           LR=2e-4, LR_BACKBONE=2e-5, LR_POINTS=1e-5, WEIGHT_DECAY=5e-4,
           CLIP_MAX_NORM=0.1, LR_SCHEDULER="MultiStep", LR_DROP_RATE=0.1,
           LR_DROP_MILESTONES=[12], EPOCHS=20, TP_DROP_RATE=0.0,
           FP_INSERT_RATE=0.0, MAX_GTS=5)
THRESH = 0.5          # UPDATE_THRESH and the IoU cut of the selection
MARGIN = 1e-3
H, W = 64, 96
B, T = 2, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU steps on one thread: the suite runs six test
    processes on the host's cores, and torch's thread pool in each of
    them oversubscribes it (``test_torch_train_loop.py`` went from 238 s
    to 69 s so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model():
    torch.manual_seed(0)
    model = randomize_(build_model(CFG), 11)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                mod.weight.add_(1.0)
        model.det_query_embed.mul_(12.5)
        model.det_anchor.mul_(12.5)
    return model


def _batch(model):
    """Images of noise, the second row padded from row 56; frame 0's GTs
    are detections 2, 9 and 17 of the model (jittered), frame 1 keeps two
    of those identities, loses one and adds a newborn (detection 25)."""
    rng = np.random.default_rng(3)
    imgs = rng.normal(size=(B, T, H, W, 3)).astype(np.float32)
    with torch.no_grad():
        out = model_forward(model, torch.from_numpy(imgs[:, 0]),
                            torch.zeros(B, H, W, dtype=torch.bool),
                            TrackState.empty(B, SLOTS, HD, 1))
    det = out["pred_boxes"].numpy()
    items = []
    for b in range(B):
        boxes0 = det[b, [2, 9, 17]] + rng.uniform(-3e-3, 3e-3, (3, 4))
        boxes1 = np.concatenate([boxes0[:2] + 0.01, det[b, [25]]])
        ids0 = np.asarray([10, 11, 12]) + 10 * b
        ids1 = np.asarray([10, 11, 13]) + 10 * b
        h = H if b == 0 else 56
        items.append({
            "imgs": [imgs[b, 0, :h], imgs[b, 1, :h]],
            "infos": [{"boxes": bx.astype(np.float32), "ids": ids,
                       "labels": np.zeros(3, np.int64),
                       "areas": bx[:, 2] * bx[:, 3]}
                      for bx, ids in ((boxes0, ids0), (boxes1, ids1))]})
    batch = collate_clips(items, CFG["MAX_GTS"], bucket_multiple=32)
    assert batch["images"].shape[2:4] == (H, W)
    return batch


def _port_grads(model):
    """Gradients as a reference-format state dict (zeros where None)."""
    named = dict(model.named_parameters(remove_duplicate=False))
    sd = {}
    for name, v in model.state_dict().items():
        p = named.get(name)
        sd[name] = (v if p is None else p.grad if p.grad is not None
                    else torch.zeros_like(p)).detach().numpy()
    params, uparams, _ = convert_torch_state_dict(sd)
    assert params.pop("_unconverted") == []
    return {"model": params, "updater": uparams}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_setup(cfg, params, uparams):
    jmodel = jax_build_model(cfg)
    jupd = build_query_updater(cfg)
    opt = make_optimizer(cfg)
    trainable = {"model": params, "updater": uparams}
    labels = label_tree(trainable)
    cs = jax_static_config(cfg, jmodel)
    return jmodel, jupd, jax_criterion(cfg), opt, cs, labels, trainable


def _jax_lrs(cfg):
    return {k: jnp.asarray(v, jnp.float32)
            for k, v in jax_group_lrs(cfg, 0).items()}


def _adam_mu(opt_state):
    """The first moment of optax's Adam state: after one step from zero it
    is (1 - b1) x the clipped gradient."""
    for st in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(st, "mu"):
            return st.mu
    raise AssertionError("no Adam state")


@pytest.fixture(scope="module")
def runs():
    model = _port_model()
    batch = _batch(model)
    params, uparams, frozen = to_jax_trees(model.state_dict())
    jmodel, jupd, jcrit, opt, cs, labels, trainable = _jax_setup(
        CFG, params, uparams)
    step = make_train_step(jmodel, jupd, jcrit, opt, cs, labels)
    jstate, jlogs = step(init_train_state(params, uparams, opt),
                         {"frozen": frozen},
                         {k: jnp.asarray(batch[k]) for k in BATCH_KEYS},
                         jax.random.PRNGKey(0), _jax_lrs(CFG))
    # the clipped gradient, read back from Adam's first moment
    jgrads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                    _adam_mu(jstate.opt_state))

    # the port's entry; the scores and IoUs its decisions compare
    smodel = copy.deepcopy(model)
    margins, states = [], []
    orig = port_trainer.train_frame_step

    def recording_step(model_, crit, images, mask, gt, state, *args, **kw):
        losses, n_gts, st = orig(model_, crit, images, mask, gt, state,
                                 *args, **kw)
        states.append(st)
        if kw["postprocess"]:
            out = model_forward(model_, images, mask, state)
            scores = torch.sigmoid(out["pred_logits"][:, :crit.n_det, 0])
            margins.extend((scores - THRESH).abs().flatten().tolist())
            margins.extend((st.iou[st.mask] - THRESH).abs().tolist())
        return losses, n_gts, st

    port_trainer.train_frame_step = recording_step
    try:
        logs = Trainer(smodel, CFG, device="cpu").step(batch)
    finally:
        port_trainer.train_frame_step = orig
    return {"model": model, "batch": batch, "jgrads": jgrads,
            "jlogs": jlogs, "jstate": jstate, "grads": _port_grads(smodel),
            "logs": logs, "smodel": smodel, "margins": margins,
            "states": states, "trees": (params, uparams)}


def test_decisions_clear_thresholds(runs):
    assert min(runs["margins"]) >= MARGIN


def test_clip_exercises_tracking(runs):
    """Frame 0's newborn tracks keep their identities; in frame 1 two of
    them find their GT by identity and the vanished one finds none."""
    after0, frame1 = runs["states"]
    for b in range(B):
        live = after0.ids[b][after0.mask[b]].tolist()
        assert {10 + 10 * b, 11 + 10 * b, 12 + 10 * b} <= set(live)
        ids, matched = frame1.ids[b].tolist(), frame1.matched_idx[b].tolist()
        found = {i: m for i, m in zip(ids, matched)}
        assert found[10 + 10 * b] == 0 and found[11 + 10 * b] == 1
        assert found[12 + 10 * b] == -1
    assert float(runs["logs"]["n_gts"]) == 12.0


def test_losses_and_logs_match_jax(runs):
    logs, jlogs = runs["logs"], runs["jlogs"]
    assert set(jlogs) - {"grad_norm"} <= set(logs), set(jlogs) ^ set(logs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert float(jlogs["grad_norm"]) > CFG["CLIP_MAX_NORM"]   # clipping on


def _assert_grads_close(got, want):
    """Per leaf: relative L2 error <= 1e-2 and every element within 5e-2 of
    the leaf's largest gradient.  Float32 through a 2-frame graph puts
    ~1e-6 relative differences on every activation; the ResNet's ReLUs and
    the bilinear taps' floor turn those into a few elements that jump
    where an input sits within rounding of a kink (measured on this clip:
    the backbone 1e-3 relative L2; the encoder's sampling offsets 2.4e-2 of
    the leaf's largest in two columns, 5.9e-3 relative L2, from one or two
    taps on a pixel crossing, while their other columns agree to 1e-5).
    Leaves whose gradient is below 1e-6 of the largest leaf are zero in
    exact arithmetic (the key biases of softmax attention shift every
    logit of a row alike) and hold only rounding noise: they must stay
    that small.  Returns how many leaves carry a live gradient."""
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    live = 0
    for k, w in want.items():
        g, scale = got[k], np.abs(w).max()
        if scale <= 1e-6 * top:
            assert np.abs(g).max() <= 1e-6 * top, k
            continue
        live += 1
        assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w), k
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-2 * scale,
                                   err_msg=k)
    return live


def test_every_gradient_matches_jax(runs):
    want = _leaves(runs["jgrads"])
    assert _assert_grads_close(_leaves(runs["grads"]), want) \
        > 0.8 * len(want)


def test_parameters_after_one_step_match_jax(runs):
    """The port's step is AdamW's first step on its own clipped gradients
    (p - lr wd p - lr g / (|g| + 1e-8), to 1e-3 lr and two float32
    roundings of p), and lands where
    JAX's, to 0.1 lr, wherever |g| >= 1e-6 (there the step is within 1% of
    its saturated size lr, so the gradients' agreement carries over; below,
    the step is the ratio of two rounding-sized numbers).  Measured: 6% of
    lr at one element of the encoder's sampling offsets, the pixel
    crossing of the gradient test."""
    params, uparams = runs["trees"]
    sd = {k: v.detach().numpy() for k, v in runs["smodel"].state_dict().items()}
    p2, u2, _ = convert_torch_state_dict(sd)
    p2.pop("_unconverted")
    got = _leaves({"model": p2, "updater": u2})
    want = _leaves(runs["jstate"].params)
    before = _leaves({"model": params, "updater": uparams})
    grads, jgrads = _leaves(runs["grads"]), _leaves(runs["jgrads"])
    lrs = port_trainer.group_lrs(CFG, 0)
    label = _leaves(label_tree({"model": params, "updater": uparams}))
    for k, w in want.items():
        lr = lrs[str(label[k])]
        if lr == 0.0:
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)
            continue
        g = grads[k]
        adamw = before[k] - lr * CFG["WEIGHT_DECAY"] * before[k] \
            - lr * g / (np.abs(g) + 1e-8)
        np.testing.assert_allclose(got[k], adamw, rtol=2.5e-7,
                                   atol=1e-3 * lr, err_msg=k)
        big = np.abs(jgrads[k]) >= 1e-6
        np.testing.assert_allclose(got[k][big], w[big], rtol=0,
                                   atol=0.1 * lr, err_msg=k)
    np.testing.assert_allclose(float(runs["logs"]["grad_norm"]),
                               float(runs["jlogs"]["grad_norm"]), rtol=1e-4)


def test_frozen_parameters_get_no_gradient(runs):
    model = runs["smodel"]
    for name, p in model.named_parameters():
        frozen = port_trainer.param_group_label(name) == "frozen"
        assert p.requires_grad != frozen, name
        assert (p.grad is None) == frozen, name


def test_accumulation_matches_one_step():
    """Two accumulated micro-batches of the same clip (each loss / 2) take
    the same step as one train step on it (float32; 1e-7 for sums of two
    halves in another order)."""
    model = _port_model()
    batch = _batch(model)
    one = Trainer(copy.deepcopy(model), CFG, device="cpu")
    one.step(batch)
    acc = Trainer(copy.deepcopy(model), dict(CFG, ACCUMULATION_STEPS=2),
                  device="cpu")
    logs = acc.step(batch)
    assert "grad_norm" not in logs
    logs = acc.step(batch)
    assert "grad_norm" in logs
    for (name, a), b in zip(one.model.named_parameters(),
                            acc.model.parameters()):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0, msg=name)


def test_entry_without_a_card_raises_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(build_model(CFG), CFG)
