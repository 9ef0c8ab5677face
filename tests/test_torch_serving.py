"""The port's serving export (``memotr_tpu_torch/serving.py``) against the
JAX package's (float32, CPU), on the deformable model at the tiny size of
tests/test_serving.py (64x96 frames, C = 32, 12 detection queries, 8
slots, 1 encoder and 2 decoder layers, thresholds 0).

The weights are one JAX tree filled from a numpy seed, mapped onto the
port with ``state_dict_from_jax``.  The port exports its step on the CPU
(``export_streaming(..., device="cpu")``) and ``ServingRuntime`` steps the
artifact over 3 frames; JAX's ``make_eval_step_packed`` (the step that
JAX's ``export_streaming`` serializes; this file's one JAX compile) steps
the same frames.  Rows: id, label, alive and overflow equal, box and score
columns within 1e-4 (float32 sums in another order through ResNet-50, the
encoder and two decoder layers; measured: a few 1e-7).

Also: ``reset()`` replays bit for bit; the artifact loads and steps in a
process that imports neither JAX nor the port's model or engine modules;
the exported graph holds K1 as one op node per encoder and decoder layer;
``torch.library.opcheck`` passes on both ops; a ``cuda`` artifact raises
without a card.  ``test_torch_serving_windowed.py`` holds the windowed
model's rows with these helpers.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memotr_tpu.engine.submit import make_eval_step_packed
from memotr_tpu.models.memotr import build_model as jax_build_model
from memotr_tpu.models.query_updater import build_query_updater
from memotr_tpu.structures.track_state import TrackState as JaxTrackState
from memotr_tpu_torch.checkpoint.convert import state_dict_from_jax
from memotr_tpu_torch.ops import library
from memotr_tpu_torch.serving import (PACKED_LAYOUT, ServingRuntime,
                                      export_streaming)
from test_serving import CONFIG as JAX_SERVING_CONFIG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, C, SLOTS = 64, 96, 32, 8
N_FRAMES = 3
CONFIG = dict(JAX_SERVING_CONFIG, ENCODER_TYPE="deformable")
ROW_ATOL = 1e-4
EXACT = [0, 1, 7, 8]           # id, label, alive, overflow


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny models in one torch thread: the suite runs six workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_trees(cfg, seed):
    """(params, uparams, frozen) of the JAX model at this file's size,
    filled from a numpy seed (std 0.08, norms' scales around one)."""
    model, updater = jax_build_model(cfg), build_query_updater(cfg)
    st = JaxTrackState.empty(1, SLOTS, C, 1)
    variables = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32),
        jax.ShapeDtypeStruct((1, H, W), bool), st.query_embed, st.ref_pts,
        st.mask)
    uvars = jax.eval_shape(updater.init, jax.random.PRNGKey(1),
                           st.query_embed, st.ref_pts, st.logits, st.boxes,
                           st.output_embed, st.last_output, st.long_memory,
                           st.mask)
    rng = np.random.default_rng(seed)

    def param(path, s):
        v = rng.normal(size=s.shape).astype(np.float32) * 0.08
        return v + 1.0 if jax.tree_util.keystr(path).endswith(
            "['scale']") else v

    def frozen(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['running_var']"):
            return rng.uniform(0.5, 1.5, size=s.shape).astype(np.float32)
        v = rng.normal(size=s.shape).astype(np.float32) * 0.3
        return v + 1.0 if name.endswith("['weight']") else v

    fill = jax.tree_util.tree_map_with_path
    return (fill(param, variables["params"]), fill(param, uvars["params"]),
            fill(frozen, variables["frozen"]))


def frames(n=N_FRAMES):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 255, (H, W, 3), np.uint8),
             np.zeros((H, W), bool)) for _ in range(n)]


def serve_both(cfg, out_dir, seed=3):
    """Export the port's step of ``cfg`` to ``out_dir`` and step it and
    JAX's packed step over ``frames()`` -> (the port's runtime, its rows,
    JAX's rows)."""
    params, uparams, frozen = jax_trees(cfg, seed)
    export_streaming(cfg, state_dict_from_jax(params, uparams, frozen),
                     out_dir, canvas_hw=(H, W), device="cpu")
    rt = ServingRuntime.load(out_dir)
    model, updater = jax_build_model(cfg), build_query_updater(cfg)
    step = make_eval_step_packed(model, updater, model.n_det_queries,
                                 cfg["DET_SCORE_THRESH"],
                                 cfg["TRACK_SCORE_THRESH"],
                                 cfg["MISS_TOLERANCE"])
    state = JaxTrackState.empty(1, SLOTS, C, 1, use_dab=True)
    got, want = [], []
    for img, msk in frames():
        got.append(rt.step(img, msk))
        packed, state = step({"params": params, "frozen": frozen},
                             {"params": uparams}, jnp.asarray(img)[None],
                             jnp.asarray(msk)[None], state)
        want.append(np.asarray(packed)[0])
    return rt, np.stack(got), np.stack(want)


def assert_rows_match(got, want):
    assert got.shape == want.shape == (N_FRAMES, SLOTS, 9)
    np.testing.assert_array_equal(got[..., EXACT], want[..., EXACT])
    np.testing.assert_allclose(got[..., 2:7], want[..., 2:7], rtol=0,
                               atol=ROW_ATOL)
    assert got[..., 7].any(), "no live slot: the rows hold nothing"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("serving") / "artifact")
    return (out, *serve_both(CONFIG, out))


def test_rows_match_jax(served):
    _, _, got, want = served
    assert_rows_match(got, want)


def test_manifest(served):
    m = served[1].manifest
    assert m["packed_layout"] == PACKED_LAYOUT and PACKED_LAYOUT[0] == "id"
    assert m["canvas_hw"] == [H, W] and m["batch"] == 1
    assert m["track_slots"] == SLOTS and m["input_dtype"] == "uint8"
    assert m["platforms"] == ["cpu"] and m["n_state_leaves"] == 15
    assert m["thresholds"] == {"det": 0.0, "track": 0.0, "miss_tolerance": 3}
    assert m["result_score_thresh"] == 0.0


def test_reset_replays_bit_for_bit(served):
    rt = served[1]
    rt.reset()
    first = [rt.step(i, m) for i, m in frames(2)]
    rt.reset()
    again = [rt.step(i, m) for i, m in frames(2)]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(first[1], served[2][1])


def test_loads_without_jax_or_model_code(served):
    code = (
        "import sys, numpy as np\n"
        "from memotr_tpu_torch.serving import ServingRuntime\n"
        f"rt = ServingRuntime.load({served[0]!r})\n"
        f"rows = rt.step(np.zeros(({H}, {W}, 3), np.uint8), "
        f"np.zeros(({H}, {W}), bool))\n"
        f"assert rows.shape == ({SLOTS}, 9), rows.shape\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'memotr_tpu') or m.startswith("
        "('memotr_tpu_torch.models', 'memotr_tpu_torch.engine'))]\n"
        "assert not bad, bad\n"
        "print('SELF_CONTAINED_OK')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert "SELF_CONTAINED_OK" in r.stdout, r.stderr[-3000:]


def op_nodes(rt):
    """{op name: node count} of the memotr_tpu_torch ops in the graph of
    ``rt``'s exported program."""
    counts = {}
    for node in rt._step.graph.nodes:
        name = str(node.target)
        if name.startswith(f"{library.NAMESPACE}."):
            op = name.split(".")[1]
            counts[op] = counts.get(op, 0) + 1
    return counts


def test_exported_graph_holds_the_op_nodes(served):
    assert op_nodes(served[1]) == {
        "msda_fwd": CONFIG["NUM_ENC_LAYERS"] + CONFIG["NUM_DEC_LAYERS"]}


def _msda_args():
    rng = np.random.default_rng(0)
    shapes = ((4, 6), (2, 3))
    s = sum(h * w for h, w in shapes)
    t = lambda *shape: torch.from_numpy(                     # noqa: E731
        rng.random(shape, dtype=np.float32))
    return (t(2, s, 2, 8), library.flat_shapes(shapes),
            t(2, 5, 2, 2, 3, 2) * 1.4 - 0.2, t(2, 5, 2, 2, 3))


def _window_args(with_bias):
    rng = np.random.default_rng(1)
    t = lambda *shape: torch.from_numpy(                     # noqa: E731
        rng.normal(size=shape).astype(np.float32))
    mask = torch.zeros((1, 4, 8), dtype=torch.bool)
    mask[:, 2:, 4:] = True                  # one window all padding
    return (t(1, 4, 8, 16), t(1, 4, 8, 16), mask, t(48, 16), t(48),
            t(16, 16), t(16), t(2, 8, 8) if with_bias else None, 2, 2, 4)


@pytest.mark.parametrize("op, args", [
    ("msda_fwd", _msda_args()),
    ("window_attn_fwd", _window_args(True)),
    ("window_attn_fwd", _window_args(False))],
    ids=["msda", "window_bias", "window_no_bias"])
def test_opcheck(op, args):
    torch.library.opcheck(getattr(torch.ops.memotr_tpu_torch, op).default,
                          args)


def test_cuda_artifact_without_a_card_raises(served, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    art = str(tmp_path / "cuda_artifact")
    shutil.copytree(served[0], art)
    with open(os.path.join(art, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["platforms"] = ["cuda"]
    with open(os.path.join(art, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingRuntime.load(art)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_streaming(CONFIG, {}, str(tmp_path / "x"))
