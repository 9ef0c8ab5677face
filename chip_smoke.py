"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed on its own line; any failure ends the run with a
nonzero exit and no result line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: the MSDA forward kernel from memotr_tpu_torch/csrc/ (nvcc);
3. kernel vs plain PyTorch on the card at the main path's MSDA shapes
   (encoder B=1, decoder B=1 and B=2, one awkward shape), float32 and
   bfloat16, with out-of-bounds taps; median times over 20 runs;
4. slice: the full-width deformable MeMOTR of configs/train_dancetrack.yaml
   (seeded random weights) streams 8 synthetic 800x1536 uint8 frames
   through the port's Submitter in bfloat16 and writes MOT txt; checks
   finite outputs, live tracks, the kernel's launch count and the txt;
5. one float32 frame of the same model through the kernel and through the
   plain MSDA (TF32 off), compared;
then a JSON line of kernel results and, last, the device line
``{"ok": true, "device": {...}}``.

There is no CPU path: without a CUDA device the script exits nonzero.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ENC_SHAPES = ((100, 192), (50, 96), (25, 48), (13, 24))   # 800x1536 / 8..64
KERNEL_SRC = "memotr_tpu_torch/csrc/msda_fwd.cu"
TPU_KERNEL = "memotr_tpu/ops/msda_pallas.py:65"
F32_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_ATOL = 2e-2
# one float32 frame, kernel vs plain MSDA: both are float32 sums over the
# same taps in another order (~1e-6 per call), carried through 12 MSDA
# layers and the heads
FRAME_ATOL = {"pred_logits": 1e-3, "pred_boxes": 1e-3}

# configs/train_dancetrack.yaml, the fields the streaming slice reads
CONFIG = {
    "DATASET": "DanceTrack", "HIDDEN_DIM": 256, "FFN_DIM": 2048,
    "NUM_FEATURE_LEVELS": 4, "NUM_HEADS": 8, "NUM_ENC_POINTS": 4,
    "NUM_DEC_POINTS": 4, "NUM_ENC_LAYERS": 6, "NUM_DEC_LAYERS": 6,
    "MERGE_DET_TRACK_LAYER": 1, "NUM_DET_QUERIES": 300, "USE_DAB": True,
    "EXTRA_TRACK_ATTN": False, "UPDATE_THRESH": 0.5,
    "LONG_MEMORY_LAMBDA": 0.01, "DET_SCORE_THRESH": 0.5,
    "TRACK_SCORE_THRESH": 0.5, "RESULT_SCORE_THRESH": 0.5,
    "MISS_TOLERANCE": 30, "TRACK_SLOTS": 64, "DTYPE": "bfloat16",
    "EVAL_SHORT_SIDE": 800, "EVAL_MAX_SIDE": 1536,
}
N_FRAMES = 8
CANVAS = (800, 1536)
ORI_HW = (720, 1440)         # resizes to 768x1536: the last 32 rows are pad
RESIZED = (768, 1536)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def msda_inputs(seed, b, shapes, m, d, p, lq, dtype, device):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.normal(size=(b, s, m, d)).astype(np.float32)
    loc = rng.uniform(-0.15, 1.15, size=(b, lq, m, len(shapes), p, 2)
                      ).astype(np.float32)
    aw = rng.uniform(size=(b, lq, m, len(shapes) * p)).astype(np.float32)
    aw = (aw / aw.sum(-1, keepdims=True)).reshape(b, lq, m, len(shapes), p)
    return (torch.from_numpy(value).to(device, dtype),
            torch.from_numpy(loc).to(device), torch.from_numpy(aw).to(device))


def median_ms(fn, runs: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_kernels(msda_cuda, plain, device):
    """Kernel vs plain version on the card; returns (max f32 error, times)."""
    cases = [("encoder", 1, ENC_SHAPES, 8, 32, 4, sum(h * w for h, w in ENC_SHAPES)),
             ("decoder_b1", 1, ENC_SHAPES, 8, 32, 4, 364),
             ("decoder_b2", 2, ENC_SHAPES, 8, 32, 4, 364),
             ("awkward", 1, ((11, 17),), 2, 16, 3, 5)]
    worst = 0.0
    times = {}
    with torch.inference_mode():
        for name, b, shapes, m, d, p, lq in cases:
            for dtype in (torch.float32, torch.bfloat16):
                v, loc, aw = msda_inputs(0, b, shapes, m, d, p, lq, dtype,
                                         device)
                out = msda_cuda.ms_deform_attn_cuda(v, shapes, loc, aw)
                ref = plain(v.float(), shapes, loc, aw)
                torch.cuda.synchronize()
                err = (out.float() - ref).abs().max().item()
                assert torch.isfinite(out).all(), (name, dtype)
                if dtype == torch.float32:
                    torch.testing.assert_close(out, ref, **F32_TOL)
                    worst = max(worst, err)
                    tol = f"atol {F32_TOL['atol']} rtol {F32_TOL['rtol']}"
                else:
                    assert err <= BF16_ATOL, (name, err)
                    tol = f"atol {BF16_ATOL} vs plain f32 on bf16 inputs"
                say("3 kernel", f"{name} B={b} Lq={lq} M={m} D={d} P={p} "
                    f"L={len(shapes)} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                    f"({tol}) ok")
            if name in ("encoder", "decoder_b1", "decoder_b2"):
                v, loc, aw = msda_inputs(1, b, shapes, m, d, p, lq,
                                         torch.bfloat16, device)
                k_ms = median_ms(lambda: msda_cuda.ms_deform_attn_cuda(
                    v, shapes, loc, aw))
                p_ms = median_ms(lambda: plain(v, shapes, loc, aw))
                times[name] = (k_ms, p_ms)
                say("3 kernel", f"{name} bf16 median of 20: kernel {k_ms:.4f} "
                    f"ms, plain {p_ms:.4f} ms")
    return worst, times


def synthetic_frames(seed: int = 0):
    """Moving textured blocks over a textured background (as bench.py draws
    its JPEG sequence), already at the resized 768x1536, on the 800x1536
    canvas with the last rows padded."""
    rng = np.random.default_rng(seed)
    h, w = RESIZED
    bg = rng.integers(40, 140, (h, w, 3), np.uint8)
    pos = rng.uniform([0, 0], [w - 200, h - 200], (8, 2))
    vel = rng.uniform(-15, 15, (8, 2))
    tex = [rng.integers(100, 255, (160, 120, 3), np.uint8) for _ in range(8)]
    mask = np.ones(CANVAS, bool)
    mask[:h, :w] = False
    for t in range(N_FRAMES):
        canvas = np.zeros(CANVAS + (3,), np.uint8)
        img = bg.copy()
        for i in range(8):
            x, y = int(pos[i, 0]), int(pos[i, 1])
            img[y:y + 160, x:x + 120] = tex[i]
        canvas[:h, :w] = img
        pos = np.clip(pos + vel, 0, [w - 200, h - 200])
        vel[(pos <= 0) | (pos >= [w - 200, h - 200])] *= -1
        yield {"image": canvas, "mask": mask, "ori_hw": ORI_HW,
               "path": f"{t + 1:08d}.jpg"}


def random_weights_(model, seed: int = 7):
    """Every parameter and buffer drawn from a seeded generator, as the JAX
    package's reference-parity test draws them; then norms around one and
    unit-scale detection queries, which keep the 300 queries distinct so
    that their scores spread around the thresholds and detections fire."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if "running_var" in name:
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
            else:
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.3
                          + (1.0 if "weight" in name else 0.0))
        for _, p in model.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.08)
        for mod in model.modules():
            if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                mod.weight.add_(1.0)
        model.det_query_embed.mul_(12.5)
        model.det_anchor.mul_(12.5)
    return model


def phase_slice(msda_cuda, device):
    from memotr_tpu_torch.engine.submit import Submitter
    from memotr_tpu_torch.models.memotr import build_model

    class CheckedSubmitter(Submitter):
        """Checks each frame's host results before writing them."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.live = []

        def _write_frame(self, i, results, ori_hw, path, bdd_results):
            for key in ("boxes", "scores"):
                assert np.isfinite(results[key]).all(), (i, key)
            self.live.append(int(results["mask"].sum()))
            super()._write_frame(i, results, ori_hw, path, bdd_results)

    model = random_weights_(build_model(CONFIG)).to(device).eval()
    with tempfile.TemporaryDirectory() as out_dir:
        sub = CheckedSubmitter("DanceTrack", synthetic_frames(), "synthetic",
                               out_dir, model, CONFIG, device)
        msda_cuda.launches = 0
        sub.run()
        launches = msda_cuda.launches
        with open(os.path.join(out_dir, "tracker", "synthetic.txt")) as f:
            lines = f.read().splitlines()
    live = sub.live
    assert len(live) == N_FRAMES, live
    per_frame = CONFIG["NUM_ENC_LAYERS"] + CONFIG["NUM_DEC_LAYERS"]
    assert launches == per_frame * N_FRAMES, \
        f"MSDA kernel launches {launches}, expected {per_frame * N_FRAMES}"
    assert live[0] > 0, f"no live track after frame 1: {live}"
    assert lines, "empty MOT txt"
    ms = [1e3 * s for s in sub.frame_seconds[2:]]
    say("4 slice", f"live slots per frame {live}; MOT txt lines {len(lines)}; "
        f"first line {lines[0].strip()}")
    say("4 slice", f"msda kernel launches {launches} = {per_frame} x "
        f"{N_FRAMES} frames ok")
    say("4 slice", f"bf16 ms/frame over frames 3-{N_FRAMES} (upload, step, "
        f"fetch): mean {np.mean(ms):.2f} median {np.median(ms):.2f} "
        f"min {np.min(ms):.2f} max {np.max(ms):.2f}")
    return model, launches


def phase_frame_f32(model_bf16, device):
    """One float32 frame through the kernel and through the plain MSDA."""
    from memotr_tpu_torch.engine.submit import normalize_uint8
    from memotr_tpu_torch.models import msda_module
    from memotr_tpu_torch.models.frame_step import model_forward
    from memotr_tpu_torch.models.memotr import build_model
    from memotr_tpu_torch.ops.msda import ms_deform_attn_torch
    from memotr_tpu_torch.structures.track_state import TrackState

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say("5 frame f32", "TF32 off for convs (cudnn.allow_tf32=False) and "
        "matmuls (cuda.matmul.allow_tf32=False)")
    model = build_model(dict(CONFIG, DTYPE="float32"))
    model.load_state_dict(model_bf16.state_dict())
    model.to(device).eval()
    fr = next(synthetic_frames(seed=1))
    images = normalize_uint8(torch.from_numpy(fr["image"])[None].to(device))
    mask = torch.from_numpy(fr["mask"])[None].to(device)
    state = TrackState.empty(1, CONFIG["TRACK_SLOTS"], CONFIG["HIDDEN_DIM"],
                             1, device=device)
    with torch.inference_mode():
        kern = model_forward(model, images, mask, state)
        dispatch = msda_module.ms_deform_attn
        msda_module.ms_deform_attn = ms_deform_attn_torch
        try:
            plain = model_forward(model, images, mask, state)
        finally:
            msda_module.ms_deform_attn = dispatch
    torch.cuda.synchronize()
    for key, atol in FRAME_ATOL.items():
        assert torch.isfinite(kern[key]).all(), key
        err = (kern[key] - plain[key]).abs().max().item()
        assert err <= atol, f"{key}: kernel vs plain max_abs_err {err} > {atol}"
        say("5 frame f32", f"{key} {tuple(kern[key].shape)} kernel vs plain "
            f"max_abs_err {err:.3e} (atol {atol}) ok")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke run needs "
                         "an NVIDIA GPU")
    from memotr_tpu_torch.ops import msda_cuda
    from memotr_tpu_torch.ops.msda import ms_deform_attn_torch

    device = torch.device("cuda", 0)
    t_all = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("1 device", f"torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}; card and power limit:")
    print(card, flush=True)

    t0 = time.perf_counter()
    lib = msda_cuda.build()
    say("2 build", f"{lib} from {KERNEL_SRC} in "
        f"{time.perf_counter() - t0:.1f} s")
    regs = [ln.strip() for ln in (lib.parent / "build.log").read_text()
            .splitlines() if "registers" in ln]
    if regs:
        say("2 build", f"ptxas: {regs[0]}")

    t0 = time.perf_counter()
    worst, times = phase_kernels(msda_cuda, ms_deform_attn_torch, device)
    say("3 kernel", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    model, launches = phase_slice(msda_cuda, device)
    say("4 slice", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_frame_f32(model, device)
    say("5 frame f32", f"done in {time.perf_counter() - t0:.1f} s")
    say("all", f"{time.perf_counter() - t_all:.1f} s")

    k_ms, p_ms = times["encoder"]
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "msda_fwd", "route": "cuda", "source": KERNEL_SRC,
        "replaces": TPU_KERNEL, "launches": launches,
        "max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
