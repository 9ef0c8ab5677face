"""The port's streaming slice against the JAX package (float32, CPU).

Three frames of ``eval_frame_step`` on a tiny deformable MeMOTR (2 encoder
and 3 decoder layers, 30 detection queries, 4 track slots, merge at layer
1), with the weights of one randomized port model on both sides and the JAX
side on ``MSDA_IMPL: xla``.  The seed makes tracks be born, overflow the
slots, die (MISS_TOLERANCE 2) and be replaced within the three frames.

Ids, labels, slot mask and next_id must be identical; logits agree to 1e-4,
boxes and ref_pts to 1e-5.  Every score compared with a threshold lies at
least 1e-3 from it, so a decision flip fails loudly here and not as a
flaky id mismatch.  Also: the port imports no JAX, and chip_smoke.py fails
without a GPU.
"""
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from memotr_tpu.engine.submit import _maybe_normalize
from memotr_tpu.engine.submit import format_frame_results as jax_format
from memotr_tpu.models.frame_step import eval_frame_step as jax_eval_step
from memotr_tpu.models.memotr import build_model as jax_build_model
from memotr_tpu.models.query_updater import build_query_updater
from memotr_tpu.structures.padded_frame import PaddedFrames
from memotr_tpu.structures.track_state import TrackState as JaxTrackState
from memotr_tpu_torch.engine.submit import (Submitter, format_frame_results,
                                            normalize_uint8, submit)
from memotr_tpu_torch.models.frame_step import eval_frame_step, model_forward
from memotr_tpu_torch.models.memotr import build_model
from memotr_tpu_torch.structures.track_state import TrackState
from test_torch_port_weights import HD, ND, SLOTS, TINY_CFG, randomize_, to_jax_trees

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(TINY_CFG, MISS_TOLERANCE=2)
THRESH = 0.5          # DET, TRACK, UPDATE and RESULT thresholds of CFG
MARGIN = 1e-3
N_FRAMES = 3
ORI_HW = (80, 128)    # the valid region of the padded 96x128 canvas


def _frames():
    """uint8 frames: a textured block moving over a noisy background, the
    canvas padded from row 80."""
    rng = np.random.default_rng(5)
    bg = rng.integers(40, 140, size=(96, 128, 3), dtype=np.uint8)
    tex = rng.integers(100, 255, size=(24, 20, 3), dtype=np.uint8)
    mask = np.zeros((96, 128), bool)
    mask[80:] = True
    out = []
    for f in range(N_FRAMES):
        img = bg.copy()
        img[20:44, 30 + 6 * f:50 + 6 * f] = tex
        img[mask] = 0
        out.append({"image": img, "mask": mask, "ori_hw": ORI_HW,
                    "path": f"{f:08d}.jpg"})
    return out


def _port_model():
    torch.manual_seed(0)
    model = randomize_(build_model(CFG).eval(), 3)
    with torch.no_grad():
        # norms near 1 and unit-scale queries keep the detection queries
        # distinct, so scores spread around the thresholds
        for mod in model.modules():
            if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                mod.weight.add_(1.0)
        model.det_query_embed.mul_(12.5)
        model.det_anchor.mul_(12.5)
    return model


@pytest.fixture(scope="module")
def runs():
    model = _port_model()
    params, uparams, frozen = to_jax_trees(model.state_dict())
    jmodel, jupd = jax_build_model(CFG), build_query_updater(CFG)

    @jax.jit
    def jax_step(images, mask, state):
        frames = PaddedFrames(images=_maybe_normalize(images), mask=mask)
        return jax_eval_step(jmodel, jupd, {"params": params, "frozen": frozen},
                             {"params": uparams}, frames, state, ND, THRESH,
                             THRESH, CFG["MISS_TOLERANCE"])

    jst = JaxTrackState.empty(1, SLOTS, HD, 1)
    st = TrackState.empty(1, SLOTS, HD, 1)
    out = {"jax": [], "port": [], "margins": []}
    with torch.inference_mode():
        for fr in _frames():
            img = torch.from_numpy(fr["image"])[None]
            mask = torch.from_numpy(fr["mask"])[None]
            fwd = model_forward(model, normalize_uint8(img), mask, st)
            scores = torch.sigmoid(fwd["pred_logits"][0, :, 0])
            out["margins"] += (scores[:ND] - THRESH).abs().tolist()
            out["margins"] += (scores[ND:][st.mask[0]] - THRESH).abs().tolist()
            res, st = eval_frame_step(model, normalize_uint8(img), mask, st,
                                      THRESH, THRESH, CFG["MISS_TOLERANCE"])
            out["margins"] += (res["scores"][res["mask"]] - THRESH).abs().tolist()
            jres, jst = jax_step(jnp.asarray(fr["image"])[None],
                                 jnp.asarray(fr["mask"])[None], jst)
            out["port"].append(({k: v.numpy() for k, v in res.items()}, st))
            out["jax"].append(({k: np.asarray(v) for k, v in jres.items()},
                               jax.tree_util.tree_map(np.asarray, jst)))
    out["model"] = model
    return out


def test_scores_clear_thresholds(runs):
    assert min(runs["margins"]) >= MARGIN


def test_lifecycle_is_exercised(runs):
    """Born, overflowed, killed and replaced within the three frames."""
    masks = [r["mask"][0] for r, _ in runs["port"]]
    ids = [r["ids"][0] for r, _ in runs["port"]]
    assert masks[0].any()
    assert sum(int(r["slot_overflow"].sum()) for r, _ in runs["port"]) > 0
    assert set(ids[1][masks[1]]) - set(ids[2][masks[2]])    # a track died
    assert set(ids[2][masks[2]]) - set(ids[1][masks[1]])    # one was born


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_frame_step_matches_jax(runs, frame):
    (res, st), (jres, jst) = runs["port"][frame], runs["jax"][frame]
    for key in ("ids", "labels", "mask"):
        np.testing.assert_array_equal(res[key], jres[key], err_msg=key)
    np.testing.assert_array_equal(st.next_id.numpy(), jst.next_id)
    np.testing.assert_array_equal(st.disappear_time.numpy(),
                                  jst.disappear_time)
    np.testing.assert_allclose(st.logits.numpy(), jst.logits, atol=1e-4)
    np.testing.assert_allclose(res["boxes"], jres["boxes"], atol=1e-5)
    np.testing.assert_allclose(st.ref_pts.numpy(), jst.ref_pts, atol=1e-5)
    np.testing.assert_allclose(st.query_embed.numpy(), jst.query_embed,
                               atol=1e-4)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_txt_lines_match_jax(runs, frame):
    res, jres = runs["port"][frame][0], runs["jax"][frame][0]
    args = (ORI_HW, "x.jpg", THRESH, 100, "DanceTrack")
    # the formatter itself: identical lines from identical results
    assert format_frame_results(frame, jres, *args) == \
        jax_format(frame, jres, *args)
    # the port's results: same frames and ids, coordinates to 1e-3 px
    lines = format_frame_results(frame, res, *args)[1]
    jlines = jax_format(frame, jres, *args)[1]
    assert len(lines) == len(jlines)
    for a, b in zip(lines, jlines):
        a, b = a.split(","), b.split(",")
        assert a[:2] == b[:2] and a[6:] == b[6:]
        np.testing.assert_allclose(np.float64(a[2:6]), np.float64(b[2:6]),
                                   atol=1e-3)


def test_submitter_writes_frame_step_results(runs, tmp_path):
    """Line for line the frame step's results (the eval cache off: the
    frame steps of ``runs`` compute their position maps per frame)."""
    sub = Submitter("DanceTrack", _frames(), "seq", str(tmp_path),
                    runs["model"], dict(CFG, EVAL_CACHE=False), "cpu")
    sub.run()
    with open(tmp_path / "tracker" / "seq.txt") as f:
        got = f.read().splitlines(keepends=True)
    want = []
    for i, (res, _) in enumerate(runs["port"]):
        want += format_frame_results(i, res, ORI_HW, "x", THRESH, 100,
                                     "DanceTrack")[1]
    assert got == want and len(got) > 0
    assert len(sub.frame_seconds) == N_FRAMES


@pytest.mark.parametrize("use_dab", [True, False])
def test_model_forward_matches_jax(use_dab):
    """One frame of the detector with live track slots, DAB and D-DETR."""
    cfg = dict(CFG, USE_DAB=use_dab)
    torch.manual_seed(0)
    model = randomize_(build_model(cfg).eval(), 4)
    params, _, frozen = to_jax_trees(model.state_dict(), use_dab=use_dab)
    rng = np.random.default_rng(8)
    fr = _frames()[0]
    img = normalize_uint8(torch.from_numpy(fr["image"])[None]).numpy()
    qdim = HD if use_dab else 2 * HD
    tq = rng.normal(size=(1, SLOTS, qdim)).astype(np.float32)
    tr = rng.normal(size=(1, SLOTS, 4)).astype(np.float32)
    tm = np.asarray([[True, False, True, True]])
    with torch.inference_mode():
        out = model(torch.from_numpy(img), torch.from_numpy(fr["mask"])[None],
                    torch.from_numpy(tq), torch.from_numpy(tr),
                    torch.from_numpy(tm))
    jout = jax.jit(jax_build_model(cfg).apply)(
        {"params": params, "frozen": frozen}, jnp.asarray(img),
        jnp.asarray(fr["mask"])[None], jnp.asarray(tq), jnp.asarray(tr),
        jnp.asarray(tm))
    for key, tol in (("pred_logits", 1e-4), ("pred_boxes", 1e-5),
                     ("last_ref_pts", 1e-4), ("init_ref_pts", 1e-5),
                     ("outputs", 1e-4), ("queries", 1e-4)):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   atol=tol, err_msg=key)


def test_submit_entry_reads_a_sequence(tmp_path):
    """submit(config): yaml train config + reference-format .pth + a
    DanceTrack-layout PNG sequence -> MOT txt, on CPU."""
    model = _port_model()
    torch.save({"model": model.state_dict()}, tmp_path / "model.pth")
    os.makedirs(tmp_path / "train")
    with open(tmp_path / "train" / "config.yaml", "w") as f:
        yaml.dump(CFG, f)
    img_dir = tmp_path / "data" / "DanceTrack" / "test" / "seq1" / "img1"
    os.makedirs(img_dir)
    for i, fr in enumerate(_frames()):
        cv2.imwrite(str(img_dir / f"{i + 1:08d}.png"),
                    fr["image"][:80, :, ::-1])            # RGB -> BGR
    submit({"SUBMIT_DIR": str(tmp_path), "SUBMIT_MODEL": "model.pth",
            "SUBMIT_DATA_SPLIT": "test", "DATA_ROOT": str(tmp_path / "data"),
            "EVAL_SHORT_SIDE": 80, "EVAL_MAX_SIDE": 128, **CFG}, "cpu")
    with open(tmp_path / "test" / "tracker" / "seq1.txt") as f:
        lines = f.read().splitlines()
    assert lines and all(len(ln.split(",")) == 10 for ln in lines)
    assert {int(ln.split(",")[0]) for ln in lines} <= set(range(1, N_FRAMES + 1))


PORT_MODULES = [
    "memotr_tpu_torch." + m for m in (
        "config", "ops._build", "ops.msda", "ops.msda_cuda",
        "ops.window_attn", "ops.window_attn_cuda", "utils.misc",
        "structures.track_state", "models.resnet",
        "models.position_embedding", "models.layers", "models.msda_module",
        "models.encoder", "models.windowed_encoder", "models.hybrid_encoder",
        "models.decoder", "models.transformer", "models.memotr",
        "models.eval_cache", "models.query_updater",
        "models.runtime_tracker", "models.frame_step", "engine.submit",
        "data.seq_dataset", "checkpoint.convert", "utils.box_ops",
        "structures.padded_frame", "data.loader", "ops.hungarian",
        "models.criterion", "models.track_selection", "engine.trainer",
        "models.motion", "models.conv_encoder", "data", "data.transforms",
        "data.mot", "data.dancetrack", "data.mot17", "data.bdd100k",
        "data.gen_gts", "data.native", "log.logger", "checkpoint.files",
        "engine.train", "main", "ops.library", "serving",
        "utils.debug_dump", "utils.profiling", "tools.export_serving",
        "tools.demo", "tools.reproduce_dancetrack", "models.dropout",
        "utils.distributed")]


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'memotr_tpu', 'cv2', 'yaml')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_entry_points_without_a_card_raise_unless_asked_for_cpu(tmp_path):
    """The Submitter and submit() default to CUDA and never fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = _port_model()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Submitter("DanceTrack", _frames(), "seq", str(tmp_path), model, CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        submit({"SUBMIT_DIR": str(tmp_path)})


def _run_chip_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_gpu():
    res = _run_chip_smoke(REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    res = _run_chip_smoke(str(tmp_path))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
