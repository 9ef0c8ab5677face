"""Weights between the PyTorch port and the JAX package.

- ``state_dict_from_jax`` (JAX trees -> reference-format state dict) loads
  into the port with ``strict=True``;
- ``convert_torch_state_dict(port.state_dict())`` gives the JAX trees back
  exactly, with no unconverted key;
- both directions for the DAB model and the D-DETR variant.
The JAX trees come from ``jax.eval_shape`` of the JAX model's init, filled
with seeded numpy values (no JAX compute).

The helpers above the tests are shared by the other tests/test_torch_*.py
files: the port's modules use the reference MeMOTR ``state_dict`` names,
so a parity test randomizes every parameter and buffer of a port module,
turns its state dict into JAX trees with ``convert_torch_state_dict`` and
runs both packages in float32 on the same numpy inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memotr_tpu.checkpoint.torch_convert import convert_torch_state_dict
from memotr_tpu.models.memotr import build_model as jax_build_model
from memotr_tpu.models.query_updater import build_query_updater
from memotr_tpu.structures.track_state import TrackState as JaxTrackState
from memotr_tpu_torch.checkpoint.convert import state_dict_from_jax
from memotr_tpu_torch.config import cfg_get
from memotr_tpu_torch.engine.submit import check_options
from memotr_tpu_torch.models.memotr import build_model

HD = 64
ND = 30
SLOTS = 4

# the tiny deformable model of the parity tests: 2 encoder and 3 decoder
# layers, merge-det-track at layer 1, DAB queries, float32
TINY_CFG = {
    "DATASET": "DanceTrack", "HIDDEN_DIM": HD, "FFN_DIM": 128,
    "NUM_FEATURE_LEVELS": 4, "NUM_HEADS": 8, "NUM_ENC_POINTS": 4,
    "NUM_DEC_POINTS": 4, "NUM_ENC_LAYERS": 2, "NUM_DEC_LAYERS": 3,
    "MERGE_DET_TRACK_LAYER": 1, "NUM_DET_QUERIES": ND, "DROPOUT": 0.0,
    "USE_DAB": True, "USE_CHECKPOINT": False, "DTYPE": "float32",
    "MSDA_IMPL": "xla", "TRACK_SLOTS": SLOTS, "UPDATE_THRESH": 0.5,
    "LONG_MEMORY_LAMBDA": 0.01, "DET_SCORE_THRESH": 0.5,
    "TRACK_SCORE_THRESH": 0.5, "RESULT_SCORE_THRESH": 0.5,
    "MISS_TOLERANCE": 30,
}


def randomize_(module: torch.nn.Module, seed: int,
               param_std: float = 0.08) -> torch.nn.Module:
    """Draw every parameter and buffer, so no naming or layout error can
    hide behind a structured init (zero heads, identity FrozenBN)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in module.named_buffers():
            if "running_var" in name:
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
            else:
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.3
                          + (1.0 if "weight" in name else 0.0))
        for _, p in module.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * param_std)
    return module


def to_jax_trees(state_dict, use_dab: bool = True):
    """Port state dict -> (params, uparams, frozen) JAX trees."""
    params, uparams, frozen = convert_torch_state_dict(
        {k: v.detach().numpy() for k, v in state_dict.items()},
        use_dab=use_dab)
    unconverted = params.pop("_unconverted")
    assert unconverted == [], f"converter missed keys: {unconverted[:8]}"
    return params, uparams, frozen


def prefixed(state_dict, prefix: str):
    """Sub-module state dict re-keyed under ``prefix`` (reference names)."""
    return {prefix + k: v for k, v in state_dict.items()}


def _jax_trees(cfg, seed):
    """Shape-exact JAX (params, uparams, frozen), filled from a numpy seed."""
    use_dab = cfg["USE_DAB"]
    model, updater = jax_build_model(cfg), build_query_updater(cfg)
    st = JaxTrackState.empty(1, SLOTS, HD, 1, use_dab=use_dab)
    img = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    mask = jax.ShapeDtypeStruct((1, 64, 64), bool)
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0), img, mask,
                               st.query_embed, st.ref_pts, st.mask)
    uvars = jax.eval_shape(updater.init, jax.random.PRNGKey(1),
                           st.query_embed, st.ref_pts, st.logits, st.boxes,
                           st.output_embed, st.last_output, st.long_memory,
                           st.mask)
    rng = np.random.default_rng(seed)
    fill = lambda t: jax.tree_util.tree_map(                  # noqa: E731
        lambda s: rng.normal(size=s.shape).astype(np.float32), t)
    return (fill(variables["params"]), fill(uvars["params"]),
            fill(variables["frozen"]))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_equal(got, want, name):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), (name, sorted(set(g) ^ set(w))[:8])
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name}{k}")


@pytest.mark.parametrize("use_dab", [True, False])
def test_jax_trees_round_trip_through_port(use_dab):
    cfg = dict(TINY_CFG, USE_DAB=use_dab)
    params, uparams, frozen = _jax_trees(cfg, seed=0)
    port = build_model(cfg)
    port.load_state_dict(state_dict_from_jax(params, uparams, frozen),
                         strict=True)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    p2, u2, f2 = convert_torch_state_dict(sd, use_dab=use_dab)
    assert p2.pop("_unconverted") == []
    _assert_trees_equal(p2, params, "params")
    _assert_trees_equal(u2, uparams, "updater")
    _assert_trees_equal(f2, frozen, "frozen")


def test_port_state_dict_converts_to_jax_tree_structure():
    port = build_model(TINY_CFG)
    params, uparams, frozen = _jax_trees(TINY_CFG, seed=1)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    p2, u2, f2 = convert_torch_state_dict(sd)
    assert p2.pop("_unconverted") == []
    for got, want in ((p2, params), (u2, uparams), (f2, frozen)):
        shapes = lambda t: {k: v.shape for k, v in _flat(t).items()}  # noqa
        assert shapes(got) == shapes(want)


def test_reference_key_names():
    sd = build_model(TINY_CFG).state_dict()
    for key in ("backbone.backbone.backbone.layer1.0.conv1.weight",
                "backbone.backbone.backbone.layer2.0.downsample.1.running_var",
                "feature_projs.3.0.weight", "feature_projs.0.1.bias",
                "transformer.encoder.layers.1.self_attn.sampling_offsets.bias",
                "transformer.decoder.layers.0.self_attn.in_proj_weight",
                "transformer.decoder.ref_point_head.layers.1.weight",
                "transformer.decoder.query_scale.layers.0.bias",
                "transformer.decoder.bbox_embed.2.layers.2.weight",
                "class_embed.2.bias", "bbox_embed.0.layers.2.bias",
                "det_query_embed", "det_anchor", "transformer.level_embed",
                "query_updater.confidence_weight_net.0.layers.1.weight",
                "query_updater.memory_attn.in_proj_bias",
                "query_updater.query_feat_ffn.norm.weight"):
        assert key in sd, key
    # FrozenBN statistics are buffers, not parameters
    params = dict(build_model(TINY_CFG).named_parameters())
    assert "backbone.backbone.backbone.bn1.running_mean" not in params
    assert "backbone.backbone.backbone.bn1.running_mean" in sd


def test_use_dab_default_is_shared():
    cfg = {k: v for k, v in TINY_CFG.items() if k != "USE_DAB"}
    assert cfg_get(cfg, "USE_DAB") is True
    assert build_model(cfg).use_dab is True
    # the JAX build_model has the same default
    assert jax_build_model(cfg).use_dab is True


@pytest.mark.parametrize("override", [
    {"VISUALIZE": True}, {"EXTRA_TRACK_ATTN": True}, {"DROPOUT": 0.1},
    {"USE_CHECKPOINT": True}])
def test_unported_options_raise(override):
    """Each option the port lacks is refused, by ``build_model`` or by the
    streaming entry points' ``check_options``."""
    cfg = dict(TINY_CFG, **override)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg)
        check_options(cfg)


@pytest.mark.parametrize("override", [
    {"ENCODER_TYPE": "windowed", "WINDOW_SIZE": 4},
    {"ENCODER_TYPE": "hybrid", "WINDOW_SIZE": 4}])
def test_windowed_and_hybrid_load_jax_weights(override):
    """The windowed and hybrid models build and take a JAX-initialised
    tree with ``strict=True``, every parameter landing where it belongs."""
    cfg = dict(TINY_CFG, **override)
    params, uparams, frozen = _jax_trees(cfg, seed=2)
    port = build_model(cfg)
    sd = state_dict_from_jax(params, uparams, frozen)
    port.load_state_dict(sd, strict=True)
    enc = params["transformer"]["encoder"]["layer_1"]
    attn = enc["fine"]["win_attn"] if "fine" in enc else enc["win_attn"]
    base = "transformer.encoder.layers.1." + ("fine." if "fine" in enc
                                              else "")
    np.testing.assert_array_equal(
        port.state_dict()[base + "win_attn.in_proj_weight"][:HD].numpy(),
        attn["q_proj"]["kernel"].T)
    lepe = enc["fine"]["lepe_dwconv"] if "fine" in enc else enc["lepe_dwconv"]
    np.testing.assert_array_equal(
        port.state_dict()[base + "lepe_dwconv.weight"].numpy(),
        lepe["kernel"].transpose(3, 2, 0, 1))
