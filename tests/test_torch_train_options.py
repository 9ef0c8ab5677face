"""The training options ``USE_CHECKPOINT``, ``EXTRA_TRACK_ATTN`` and
``DROPOUT`` > 0 of the port (float32, CPU), against the port itself and
the JAX package.

The model is test_torch_train_step.py's at 1 encoder and 2 decoder
layers.

- ``USE_CHECKPOINT``: one train step of the 2-frame clip of
  test_torch_train_step.py with checkpointing off and on, from the same
  weights, for the deformable, windowed (K2's plain version), hybrid and
  conv encoders: every loss and every gradient equal bit for bit (the
  recompute runs the same ops on the same inputs in the same order, and
  the backward walks the forward's own graph); the attention wrapper runs
  twice in each checkpointed gradient frame's layers and once in a
  ``NO_GRAD_FRAMES`` frame.
- ``EXTRA_TRACK_ATTN``: the model's forward with live track slots against
  JAX's (test_torch_train_step.py's tolerances), and the converters' round
  trip with no unconverted key.
- ``EXTRA_TRACK_ATTN`` with ``DROPOUT`` 0.1 and every dropout mask forced
  to all-ones on both sides (``jax.random.bernoulli``, which flax's
  ``Dropout`` calls, and the port's ``draw_keep_mask``, patched in this
  file only): one train step against JAX's ``make_train_step`` (every loss
  and log, every gradient, the gradient norm), so each site scales by
  1 / (1 - p) where JAX's does.  The one JAX compile of the file.
- ``DROPOUT`` 0.1 with real masks: checkpointing on and off from the same
  seed give equal gradients (the recompute draws the forward's masks); a
  large mask keeps 1 - p of its elements within a binomial bound; the
  windowed encoder's training step takes the composed route (no K2) and
  its streaming forward the kernel's route; a model in eval mode never
  drops.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memotr_tpu.checkpoint.torch_convert import convert_torch_state_dict
from memotr_tpu.engine.trainer import init_train_state, make_train_step
from memotr_tpu.models.memotr import build_model as jax_build_model
from memotr_tpu_torch.checkpoint.convert import state_dict_from_jax
from memotr_tpu_torch.engine.trainer import BATCH_KEYS, Trainer
from memotr_tpu_torch.models import dropout as port_dropout
from memotr_tpu_torch.models import msda_module, windowed_encoder
from memotr_tpu_torch.models.memotr import build_model
from memotr_tpu_torch.structures.track_state import TrackState
from test_torch_port_weights import (HD, SLOTS, _assert_trees_equal,
                                     _jax_trees, randomize_, to_jax_trees)
from test_torch_train_step import one_torch_thread  # noqa: F401
from test_torch_train_step import CFG as TRAIN_CFG
from test_torch_train_step import (_adam_mu, _assert_grads_close, _batch,
                                   _jax_lrs, _jax_setup, _leaves,
                                   _port_grads)
from test_torch_train_windowed_step import compiled

# test_torch_train_step.py's model at 1 encoder and 2 decoder layers (the
# second merges detections and tracks), for a shorter JAX compile
CFG = dict(TRAIN_CFG, NUM_ENC_LAYERS=1, NUM_DEC_LAYERS=2,
           AUX_LOSS_WEIGHT=[1.0])
WINDOWED = dict(ENCODER_TYPE="windowed", WINDOW_SIZE=4)
ENCODERS = {
    "deformable": {},
    "windowed": WINDOWED,
    "hybrid": dict(WINDOWED, ENCODER_TYPE="hybrid"),
    "conv": dict(ENCODER_TYPE="conv"),
}
# the JAX comparison: a merging decoder layer with track attention, and
# every dropout site live
OPTIONS_CFG = dict(CFG, EXTRA_TRACK_ATTN=True, DROPOUT=0.1)
P = 0.1


def _model(cfg, seed=11):
    """A randomized port model of ``cfg``, as test_torch_train_step.py's
    ``_port_model`` draws it (detections fire, so tracks are born)."""
    torch.manual_seed(0)
    model = randomize_(build_model(cfg), seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                mod.weight.add_(1.0)
        model.det_query_embed.mul_(12.5)
        model.det_anchor.mul_(12.5)
    return model


def _step(model, cfg, batch):
    """One Trainer step of a ``cfg`` model with ``model``'s weights;
    (logs, grads by name)."""
    m = build_model(cfg)
    m.load_state_dict(model.state_dict())
    logs = Trainer(m, cfg, device="cpu", seed=5).step(batch)
    grads = {n: p.grad.clone() for n, p in m.named_parameters()
             if p.grad is not None}
    return logs, grads


def _assert_steps_equal(a, b):
    (logs_a, grads_a), (logs_b, grads_b) = a, b
    for k, v in logs_a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, logs_b[k]), k
    assert set(grads_a) == set(grads_b)
    for n, g in grads_a.items():
        assert torch.equal(g, grads_b[n]), n


class _Counted:
    """Wraps a module function of the model, counting its calls."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.orig(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


@pytest.fixture(scope="module")
def batch():
    return _batch(_model(CFG))


@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_checkpoint_gives_identical_gradients(encoder, batch):
    """Equal steps, and each attention wrapper (K1's, K2's) runs twice as
    often with checkpointing: every layer of the encoder and the decoder
    recomputes once in the backward."""
    cfg = dict(CFG, **ENCODERS[encoder])
    model = _model(cfg)
    runs, calls = [], []
    for ckpt in (False, True):
        with _Counted(msda_module, "ms_deform_attn") as k1, \
                _Counted(windowed_encoder, "window_attention") as k2:
            runs.append(_step(model, dict(cfg, USE_CHECKPOINT=ckpt), batch))
        calls.append((k1.calls, k2.calls))
    _assert_steps_equal(*runs)
    assert runs[0][0]["params_without_grad"] == (encoder == "conv")
    (k1_off, k2_off), (k1_on, k2_on) = calls
    assert k1_off > 0 and (k2_off > 0) == (encoder in ("windowed", "hybrid"))
    assert (k1_on, k2_on) == (2 * k1_off, 2 * k2_off), calls


def test_checkpoint_recomputes_only_gradient_frames(batch):
    """With ``NO_GRAD_FRAMES`` 1 the first frame runs once (no gradient,
    no checkpoint) and the second twice."""
    per_frame = CFG["NUM_ENC_LAYERS"] + CFG["NUM_DEC_LAYERS"]
    cfg = dict(CFG, USE_CHECKPOINT=True, NO_GRAD_FRAMES=1)
    with _Counted(msda_module, "ms_deform_attn") as calls:
        _step(_model(cfg), cfg, batch)
    assert calls.calls == 3 * per_frame


def _live_slots(seed):
    rng = np.random.default_rng(seed)
    qe = rng.normal(size=(2, SLOTS, HD)).astype(np.float32)
    rp = rng.normal(size=(2, SLOTS, 4)).astype(np.float32)
    live = np.asarray([[True, True, False, True], [True, False, False,
                                                   False]])
    return qe, rp, live


def test_extra_track_attn_forward_matches_jax():
    """Deterministic forward with live track slots (the track attention
    attends over them, the dead slot masked) against JAX's."""
    cfg = dict(CFG, EXTRA_TRACK_ATTN=True)
    model = _model(cfg).eval()
    assert [layer.track_attn is not None
            for layer in model.transformer.decoder.layers] == [False, True]
    params, _, frozen = to_jax_trees(model.state_dict())
    rng = np.random.default_rng(4)
    imgs = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    mask = np.zeros((2, 64, 96), bool)
    mask[1, 56:] = True
    qe, rp, live = _live_slots(5)
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in (imgs, mask, qe, rp,
                                                    live)))
    jout = jax.jit(jax_build_model(cfg).apply)(
        {"params": params, "frozen": frozen}, imgs, mask, qe, rp, live)
    for key in ("pred_logits", "pred_boxes", "outputs"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_extra_track_attn_converters_round_trip():
    cfg = dict(CFG, EXTRA_TRACK_ATTN=True)
    params, uparams, frozen = _jax_trees(cfg, seed=3)
    port = build_model(cfg)
    port.load_state_dict(state_dict_from_jax(params, uparams, frozen),
                         strict=True)
    names = [k for k in port.state_dict() if ".track_attn." in k
             or ".norm4." in k]
    assert names and all(".layers.0." not in k for k in names)
    back, uback, fback = convert_torch_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()})
    assert back.pop("_unconverted") == []
    _assert_trees_equal(back, params, "params")
    _assert_trees_equal(uback, uparams, "uparams")
    _assert_trees_equal(fback, frozen, "frozen")


def _all_ones_torch(shape, keep, seed, device):
    return torch.ones(shape, dtype=torch.bool, device=device)


def _all_ones_jax(key, p=0.5, shape=None, mode=None):
    return jnp.ones(shape, bool)


@pytest.fixture(scope="module")
def forced_ones():
    """One train step with EXTRA_TRACK_ATTN and DROPOUT 0.1, every mask
    all-ones on both sides."""
    model = _model(OPTIONS_CFG)
    batch = _batch(model)
    params, uparams, frozen = to_jax_trees(model.state_dict())
    jmodel, jupd, jcrit, opt, cs, labels, _ = _jax_setup(
        OPTIONS_CFG, params, uparams)
    assert cs["dropout"] == P
    step = make_train_step(jmodel, jupd, jcrit, opt, cs, labels)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", _all_ones_jax)
        jstate, jlogs = compiled(
            step, init_train_state(params, uparams, opt), {"frozen": frozen},
            {k: jnp.asarray(batch[k]) for k in BATCH_KEYS},
            jax.random.PRNGKey(0), _jax_lrs(OPTIONS_CFG))
        mp.setattr(port_dropout, "draw_keep_mask", _all_ones_torch)
        smodel = copy.deepcopy(model)
        logs = Trainer(smodel, OPTIONS_CFG, device="cpu").step(batch)
    jgrads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                    _adam_mu(jstate.opt_state))
    return {"logs": logs, "jlogs": jlogs, "grads": _port_grads(smodel),
            "jgrads": jgrads, "smodel": smodel}


def test_forced_mask_losses_match_jax(forced_ones):
    logs, jlogs = forced_ones["logs"], forced_ones["jlogs"]
    assert set(jlogs) - {"grad_norm"} <= set(logs), set(jlogs) ^ set(logs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert float(logs["n_gts"]) == 12.0


def test_forced_mask_gradients_match_jax(forced_ones):
    """Every gradient at test_torch_train_step.py's tolerances, and the
    track attention's live (the step's second frame has live tracks)."""
    want = _leaves(forced_ones["jgrads"])
    assert _assert_grads_close(_leaves(forced_ones["grads"]), want) \
        > 0.8 * len(want)
    for name, p in forced_ones["smodel"].named_parameters():
        if ".track_attn." in name or ".norm4." in name:
            assert p.grad is not None and p.grad.abs().max() > 0, name


@pytest.mark.parametrize("encoder", ["deformable", "windowed"])
def test_dropout_with_checkpoint_gives_the_same_gradients(encoder, batch):
    """Real masks, the same trainer seed: the checkpointed step recomputes
    each layer under its forward's seed and draws the same masks again.
    The windowed encoder takes the composed route there, never K2's."""
    cfg = dict(CFG, **ENCODERS[encoder], DROPOUT=P)
    model = _model(cfg)
    runs, draws = [], []
    for ckpt in (False, True):
        with _Counted(port_dropout, "draw_keep_mask") as masks, \
                _Counted(windowed_encoder, "window_attention") as k2, \
                _Counted(windowed_encoder, "window_attention_torch") as comp:
            runs.append(_step(model, dict(cfg, USE_CHECKPOINT=ckpt), batch))
        draws.append(masks.calls)
        assert k2.calls == 0
        assert (comp.calls > 0) == (encoder == "windowed")
    _assert_steps_equal(*runs)
    assert 0 < draws[0] < draws[1], draws


def test_mask_keeps_one_minus_p():
    n, keep = 10 ** 6, 1 - P
    masks = [port_dropout.draw_keep_mask((n,), keep, s, torch.device("cpu"))
             for s in (1, 1, 2)]
    share = masks[0].double().mean().item()
    assert abs(share - keep) <= 6 * np.sqrt(keep * P / n), share
    assert torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0], masks[2])
    # sites and calls fold into distinct seeds
    seeds = {port_dropout.mix_seed(7, site, call)
             for site in range(50) for call in range(4)}
    assert len(seeds) == 200


def test_windowed_eval_takes_the_kernel_route(batch):
    """A model trained at DROPOUT > 0 streams (eval mode, no gradient)
    through K2's route, once a level of every layer, inside a dropout seed
    as well."""
    cfg = dict(CFG, **WINDOWED, DROPOUT=P)
    model = _model(cfg).eval()
    state = TrackState.empty(2, SLOTS, HD, 1)
    with _Counted(windowed_encoder, "window_attention") as k2, \
            _Counted(windowed_encoder, "window_attention_torch") as comp, \
            port_dropout.dropout_seed(3), torch.no_grad():
        model(torch.from_numpy(batch["images"][:, 0]),
              torch.from_numpy(batch["mask"][:, 0]), state.query_embed,
              state.ref_pts, state.mask)
    assert (k2.calls, comp.calls) == (
        cfg["NUM_ENC_LAYERS"] * cfg["NUM_FEATURE_LEVELS"], 0)


def test_eval_mode_never_drops(batch):
    """A model in eval mode (streaming, a distillation teacher) computes
    the same frame inside a dropout seed as outside one."""
    model = _model(dict(CFG, DROPOUT=0.5)).eval()
    st = TrackState.empty(2, SLOTS, HD, 1)
    args = (torch.from_numpy(batch["images"][:, 0]),
            torch.from_numpy(batch["mask"][:, 0]), st.query_embed,
            st.ref_pts, st.mask)
    with torch.no_grad():
        plain = model(*args)["pred_logits"]
        with port_dropout.dropout_seed(9):
            seeded = model(*args)["pred_logits"]
    assert torch.equal(plain, seeded)
