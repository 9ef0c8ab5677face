"""Per-module parity of the PyTorch port against the JAX package (float32,
CPU, tiny widths).

Each port module is randomized, its state dict is converted to JAX trees
with ``convert_torch_state_dict`` (the reference key names), and both sides
run on the same numpy inputs.  Tolerances: atol 1e-5 for modules, 1e-4 for
ResNet-50 (53 convolutions summed in another order); slot-bank updates and
the mask downsample must match exactly.  Sine position embeddings are
compared on the valid region only: at padded positions the eps division
amplifies 1-ulp cumsum differences.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memotr_tpu.models import decoder as jdec
from memotr_tpu.models import encoder as jenc
from memotr_tpu.models import layers as jlayers
from memotr_tpu.models import memotr as jmemotr
from memotr_tpu.models import msda_module as jmsda
from memotr_tpu.models import position_embedding as jpe
from memotr_tpu.models import query_updater as jqu
from memotr_tpu.models import resnet as jresnet
from memotr_tpu.structures import track_state as jts
from memotr_tpu.utils import misc as jmisc
from memotr_tpu_torch.models import decoder as tdec
from memotr_tpu_torch.models import encoder as tenc
from memotr_tpu_torch.models import layers as tlayers
from memotr_tpu_torch.models import memotr as tmemotr
from memotr_tpu_torch.models import msda_module as tmsda
from memotr_tpu_torch.models import position_embedding as tpe
from memotr_tpu_torch.models import query_updater as tqu
from memotr_tpu_torch.models import resnet as tresnet
from memotr_tpu_torch.structures import track_state as tts
from memotr_tpu_torch.utils import misc as tmisc
from test_torch_port_weights import prefixed, randomize_, to_jax_trees

C = 32
SHAPES = ((8, 10), (4, 5), (2, 3), (1, 2))
S_TOK = sum(h * w for h, w in SHAPES)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(a, b, atol=1e-5, rtol=1e-5, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol,
                               err_msg=msg)


# ----------------------------------------------------------------- misc
def test_misc_helpers():
    x = _rng(0).uniform(-0.2, 1.2, size=(5, 7)).astype(np.float32)
    _close(tmisc.inverse_sigmoid(torch.from_numpy(x)),
           jmisc.inverse_sigmoid(jnp.asarray(x)))
    _close(tmisc.logits_to_scores(torch.from_numpy(x * 8)),
           jmisc.logits_to_scores(jnp.asarray(x * 8)))
    pos = _rng(1).uniform(size=(2, 6, 4)).astype(np.float32)
    _close(tmisc.pos_to_pos_embed(torch.from_numpy(pos), 16),
           jmisc.pos_to_pos_embed(jnp.asarray(pos), 16))


@pytest.mark.parametrize("hw,pad", [((96, 128), (80, 128)), ((37, 53), (30, 41)),
                                    ((25, 48), (25, 48))])
def test_sine_position_embedding_valid_region(hw, pad):
    mask = np.ones((2,) + hw, bool)
    mask[0, :pad[0], :pad[1]] = False
    mask[1, :hw[0] - 3, :hw[1] - 5] = False
    t = _np(tpe.sine_position_embedding(torch.from_numpy(mask), 16))
    j = np.asarray(jpe.sine_position_embedding(jnp.asarray(mask), 16))
    valid = ~mask
    np.testing.assert_allclose(t[valid], j[valid], atol=1e-5)


@pytest.mark.parametrize("hw_in,hw_out", [((96, 128), (12, 16)),
                                          ((96, 128), (3, 4)),
                                          ((100, 150), (13, 19)),
                                          ((80, 61), (7, 9))])
def test_downsample_mask_exact(hw_in, hw_out):
    mask = _rng(2).uniform(size=(2,) + hw_in) > 0.5
    mask[:, 70:] = True
    t = tmemotr._downsample_mask(torch.from_numpy(mask), *hw_out)
    j = jmemotr._downsample_mask(jnp.asarray(mask), *hw_out)
    np.testing.assert_array_equal(_np(t), np.asarray(j))


# ----------------------------------------------------------------- layers
def _linear_params(mod):
    return {"kernel": _np(mod.weight).T, "bias": _np(mod.bias)}


def test_mlp_and_ffn():
    rng = _rng(3)
    x = rng.normal(size=(2, 5, C)).astype(np.float32)
    mlp = randomize_(tlayers.MLP(C, 48, 16, 3), 0, 0.3)
    p = {f"layers_{i}": _linear_params(l) for i, l in enumerate(mlp.layers)}
    _close(mlp(torch.from_numpy(x)),
           jlayers.MLP(48, 16, 3).apply({"params": p}, jnp.asarray(x)))

    ffn = randomize_(tlayers.FFN(C, 64), 1, 0.3)
    p = {"linear1": _linear_params(ffn.linear1),
         "linear2": _linear_params(ffn.linear2),
         "norm": {"scale": _np(ffn.norm.weight), "bias": _np(ffn.norm.bias)}}
    _close(ffn(torch.from_numpy(x)),
           jlayers.FFN(64).apply({"params": p}, jnp.asarray(x)))


def test_multihead_attention_key_padding():
    rng = _rng(4)
    q = rng.normal(size=(2, 7, C)).astype(np.float32)
    k = rng.normal(size=(2, 9, C)).astype(np.float32)
    v = rng.normal(size=(2, 9, C)).astype(np.float32)
    kpm = rng.uniform(size=(2, 9)) > 0.6
    kpm[1] = True                                   # a fully masked row
    mha = randomize_(tlayers.MultiheadAttention(C, 4), 2, 0.3)
    sd = prefixed(mha.state_dict(), "query_updater.memory_attn.")
    _, uparams, _ = to_jax_trees(sd)
    t = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            key_padding_mask=torch.from_numpy(kpm))
    j = jlayers.MultiheadAttention(4).apply(
        {"params": uparams["memory_attn"]}, jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v), key_padding_mask=jnp.asarray(kpm))
    _close(t, j)


# ----------------------------------------------------------------- resnet
def test_resnet50():
    x = _rng(5).normal(size=(1, 64, 96, 3)).astype(np.float32)
    net = randomize_(tresnet.ResNet50(), 3)
    with torch.no_grad():        # unit-gain convs keep activations O(1)
        for mod in net.modules():
            if isinstance(mod, torch.nn.Conv2d):
                mod.weight.mul_(1.0 / (0.08 * mod.weight[0].numel() ** 0.5))
    params, _, frozen = to_jax_trees(
        prefixed(net.state_dict(), "backbone.backbone.backbone."))
    t = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    j = jresnet.ResNet50().apply(
        {"params": params["backbone"], "frozen": frozen["backbone"]},
        jnp.asarray(x))
    for lvl, (a, b) in enumerate(zip(t, j)):
        _close(a.permute(0, 2, 3, 1), b, atol=1e-4, rtol=1e-4,
               msg=f"level {lvl}")


# ----------------------------------------------------------------- MSDA
def _msda_inputs(seed, lq, ref_dim):
    rng = _rng(seed)
    query = rng.normal(size=(2, lq, C)).astype(np.float32)
    src = rng.normal(size=(2, S_TOK, C)).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, size=(2, lq, len(SHAPES), ref_dim)
                      ).astype(np.float32)
    pad = rng.uniform(size=(2, S_TOK)) > 0.8
    return query, ref, src, pad


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_msdeform_attn(ref_dim):
    query, ref, src, pad = _msda_inputs(6, 11, ref_dim)
    mod = randomize_(tmsda.MSDeformAttn(C, 4, 4, 3), 4, 0.3)
    params, _, _ = to_jax_trees(
        prefixed(mod.state_dict(), "transformer.encoder.layers.0.self_attn."))
    t = mod(torch.from_numpy(query), torch.from_numpy(ref),
            torch.from_numpy(src), SHAPES, torch.from_numpy(pad))
    j = jmsda.MSDeformAttn(C, 4, 4, 3, impl="xla").apply(
        {"params": params["transformer"]["encoder"]["layer_0"]["self_attn"]},
        jnp.asarray(query), jnp.asarray(ref), jnp.asarray(src), SHAPES,
        jnp.asarray(pad))
    _close(t, j)


def _valid_ratios(seed):
    return _rng(seed).uniform(0.7, 1.0, size=(2, len(SHAPES), 2)
                              ).astype(np.float32)


def test_encoder():
    rng = _rng(7)
    src = rng.normal(size=(2, S_TOK, C)).astype(np.float32)
    pos = rng.normal(size=(2, S_TOK, C)).astype(np.float32)
    pad = rng.uniform(size=(2, S_TOK)) > 0.8
    vr = _valid_ratios(8)
    enc = randomize_(tenc.Encoder(2, C, 64, 4, 4, 4), 5, 0.3)
    params, _, _ = to_jax_trees(prefixed(enc.state_dict(),
                                         "transformer.encoder."))
    t = enc(torch.from_numpy(src), SHAPES, torch.from_numpy(vr),
            torch.from_numpy(pos), torch.from_numpy(pad))
    j = jenc.Encoder(2, C, 64, 4, 4, 4, msda_impl="xla").apply(
        {"params": params["transformer"]["encoder"]}, jnp.asarray(src),
        SHAPES, jnp.asarray(vr), jnp.asarray(pos), jnp.asarray(pad))
    _close(t, j)


def test_decoder_merge_det_track():
    nd, n_slots, n_layers = 6, 3, 3
    rng = _rng(9)
    tgt = rng.normal(size=(2, nd + n_slots, C)).astype(np.float32)
    ref = rng.uniform(0.2, 0.8, size=(2, nd + n_slots, 4)).astype(np.float32)
    src = rng.normal(size=(2, S_TOK, C)).astype(np.float32)
    pad = rng.uniform(size=(2, S_TOK)) > 0.8
    qmask = np.zeros((2, nd + n_slots), bool)
    qmask[0, nd + 1:] = True
    vr = _valid_ratios(10)

    dec = tdec.Decoder(n_layers, C, 64, 4, 4, 4, n_det_queries=nd,
                       merge_det_track_layer=1)
    class_embed = torch.nn.ModuleList(
        tlayers.Linear(C, 1) for _ in range(n_layers))
    dec.bbox_embed = torch.nn.ModuleList(
        tdec.bbox_head(C, 0.0) for _ in range(n_layers))
    holder = torch.nn.ModuleDict({"decoder": dec, "class_embed": class_embed})
    randomize_(holder, 6, 0.3)
    sd = prefixed(dec.state_dict(), "transformer.decoder.")
    sd.update(prefixed(class_embed.state_dict(), "class_embed."))
    params, _, _ = to_jax_trees(sd)

    t = dec(torch.from_numpy(tgt), torch.from_numpy(ref),
            torch.from_numpy(src), SHAPES, torch.from_numpy(vr), None,
            torch.from_numpy(qmask), torch.from_numpy(pad), class_embed)
    j = jdec.Decoder(n_layers, C, 64, 4, 4, 4, num_classes=1,
                     n_det_queries=nd, merge_det_track_layer=1,
                     msda_impl="xla").apply(
        {"params": params["transformer"]["decoder"]}, jnp.asarray(tgt),
        jnp.asarray(ref), jnp.asarray(src), SHAPES, jnp.asarray(vr), None,
        jnp.asarray(qmask), jnp.asarray(pad))
    for key in ("outputs", "refs", "queries", "logits", "boxes",
                "init_reference"):
        _close(t[key], j[key], msg=key)
    # layer 0 runs before the merge: track queries and refs pass through
    _close(t["outputs"][0][:, nd:], tgt[:, nd:], atol=0, rtol=0)
    _close(t["refs"][0][:, nd:], ref[:, nd:], atol=0, rtol=0)


@pytest.mark.parametrize("use_dab", [True, False])
def test_query_updater(use_dab):
    b, s = 2, 6
    qdim = C if use_dab else 2 * C
    rng = _rng(11)
    ins = [rng.normal(size=(b, s, qdim)), rng.normal(size=(b, s, 4)),
           rng.normal(size=(b, s, 1)) * 2,
           rng.uniform(0.1, 0.9, size=(b, s, 4)),
           rng.normal(size=(b, s, C)), rng.normal(size=(b, s, C)),
           rng.normal(size=(b, s, C))]
    ins = [a.astype(np.float32) for a in ins]
    live = np.asarray([[1, 1, 1, 0, 1, 0], [0, 1, 0, 0, 0, 0]], bool)
    upd = randomize_(tqu.QueryUpdater(C, 64, use_dab=use_dab), 7, 0.3)
    _, uparams, _ = to_jax_trees(prefixed(upd.state_dict(), "query_updater."),
                                 use_dab=use_dab)
    t = upd(*[torch.from_numpy(a) for a in ins], torch.from_numpy(live))
    j = jqu.QueryUpdater(C, 64, use_dab=use_dab).apply(
        {"params": uparams}, *[jnp.asarray(a) for a in ins], jnp.asarray(live))
    for key in ("query_embed", "ref_pts", "long_memory", "last_output"):
        _close(t[key], j[key], msg=key)


# ----------------------------------------------------------------- slots
def _random_bank(seed, b=3, s=5, n=7, c=4):
    rng = _rng(seed)
    occupied = rng.uniform(size=(b, s)) > 0.5
    occupied[2] = True                                  # a full row
    cmask = rng.uniform(size=(b, n)) > 0.3
    cmask[0] = True                                     # overflow
    cand = {"mask": cmask,
            "ids": rng.integers(0, 100, size=(b, n)).astype(np.int32),
            "labels": rng.integers(0, 3, size=(b, n)).astype(np.int32),
            "boxes": rng.uniform(size=(b, n, 4)).astype(np.float32),
            "query_embed": rng.normal(size=(b, n, c)).astype(np.float32),
            "long_memory": rng.normal(size=(b, n, c)).astype(np.float32)}
    fill = {"ids": rng.integers(100, 200, size=(b, s)).astype(np.int32),
            "boxes": rng.uniform(size=(b, s, 4)).astype(np.float32),
            "query_embed": rng.normal(size=(b, s, c)).astype(np.float32)}
    return occupied, fill, cand


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_insert_tracks_and_overflow_exact(seed):
    occupied, fill, cand = _random_bank(seed)
    b, s = occupied.shape
    c = fill["query_embed"].shape[-1]
    jst = jts.TrackState.empty(b, s, c, 2).replace(
        mask=jnp.asarray(occupied),
        **{k: jnp.asarray(v) for k, v in fill.items()})
    tst = tts.TrackState.empty(b, s, c, 2).replace(
        mask=torch.from_numpy(occupied),
        **{k: torch.from_numpy(v) for k, v in fill.items()})
    jc = {k: jnp.asarray(v) for k, v in cand.items()}
    tc = {k: torch.from_numpy(v) for k, v in cand.items()}
    np.testing.assert_array_equal(_np(tts.overflow_count(tst, tc)),
                                  np.asarray(jts.overflow_count(jst, jc)))
    assert _np(tts.overflow_count(tst, tc))[0] > 0
    jout, tout = jts.insert_tracks(jst, jc), tts.insert_tracks(tst, tc)
    for f in tts.SLOT_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tout, f)),
                                      np.asarray(getattr(jout, f)), err_msg=f)
