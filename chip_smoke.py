"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed on its own line; any failure ends the run with a
nonzero exit and no result line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: the three kernels from memotr_tpu_torch/csrc/ (one nvcc each,
   in parallel), with ptxas's registers and spills per kernel;
3. K1 (MSDA forward) vs plain PyTorch on the card at the MSDA shapes of the
   paths (encoder B=1 and B=2, decoder B=1 and B=2, one awkward shape),
   float32 and
   bfloat16, with out-of-bounds taps; per call, over 20 calls, the device
   time (the call's CUDA kernels, torch.profiler) and the event-timed call
   (which includes the wrapper's host work), and the achieved rate of
   gathered corner bytes;
4. K2 (fused window attention) vs plain PyTorch at the main path's shapes
   (window level 0, grid levels 0 and 3, and window and grid level 0 at B=2
   as the batched lanes give them, with the 800x1536 canvas's padding and
   its fully padded windows) and an awkward one, float32 and bfloat16;
   device and event times of the kernel, the plain version and the library
   composition (matmuls + scaled_dot_product_attention), the kernel's
   achieved TFLOP/s, its time by CUDA kernel, and a check that bf16 took
   the fused tensor-core route;
5. deformable slice: configs/train_dancetrack.yaml (seeded random weights)
   streams synthetic 800x1536 uint8 frames through the port's Submitter in
   bfloat16, its pipelined loop (the default) under
   torch.cuda.set_sync_debug_mode("error"), so that any host-device sync
   fails the run; finite outputs, live tracks, launch counts, MOT txt; then
   the sync loop on the same frames: MOT txt byte-identical, the same
   launch counts; steady ms/frame of both loops;
6. one float32 frame of the deformable model through K1 and through the
   plain MSDA (TF32 off), compared;
7. windowed slice: the fields of
   configs/train_dancetrack_windowed.yaml, 8 frames in bfloat16 through the
   Submitter with the eval cache on, both loops as in phase 5; 12 K2 and 6
   K1 launches per frame;
8. one float32 frame of the windowed model through both kernels and
   through both plain versions (TF32 off), compared;
9. profile: 3 more windowed frames timed, then again under torch.profiler:
   host wall time, device busy time and idle share, device time by kernel
   family;
10. hybrid: configs/train_dancetrack.yaml with ENCODER_TYPE hybrid, 2
    frames, both loops; 6 K2 and 12 K1 launches per frame;
18. batched serving (SUBMIT_BATCH 2) of the deformable and the windowed
    model through stream_sequences, the grouping submit() runs: two lanes
    of unequal length in one BatchedSubmitter; at float32 (on
    scaled_weights_) each lane's frames and ids equal its B=1 run's, boxes
    within FRAME_ATOL of the frame; launch counts per step; bf16 frames/s
    at B=1 and B=2;
19. USE_MOTION: a few bf16 deformable frames through the sync loop;
11. K1 backward (csrc/msda_bwd.cu) vs autograd of the plain version at the
    training canvas's MSDA shapes (encoder B=1 Lq=28,560; decoder B=1 and
    B=2, Lq=364, out-of-bounds taps), float32 and bfloat16; device time of
    the kernel and of the plain backward, and the bound;
12. deformable training (this slice's main path): the
    configs/train_dancetrack.yaml model in bfloat16 trains through the
    port's Trainer on synthetic 896x1536 clips (864x1536 valid) of 20
    moving boxes, one entering and one leaving: 3 steps at T=2 and 1 at
    T=5; finite losses and gradient norm, every trainable parameter
    reached, the frozen stem and layer1 untouched, 12 T forward and 12 T
    backward K1 launches a step; ms per step, peak device memory, host
    matching copies; then one more T=2 step under torch.profiler (device
    time by kernel family, host matching time);
13. one float32 training step (T=1, TF32 off) through the kernels and
    through the plain MSDA, on fixed seeded weights (``scaled_weights_``:
    the forward has no atomics, so every kink falls the same way in every
    run): total loss and gradient norms compared;
14. K2 backward (csrc/window_attn_bwd.cu behind WindowAttnFunction) vs
    autograd of the plain version at the training canvas's window level 0
    (L=64) and every grid level (L=336, 84, 24, 6), the streaming canvas's
    window level 0 (its fully padded windows) and grid level 0 (L=312), and
    an awkward shape, float32 and bfloat16, every gradient compared; device
    time (at the training canvas's window level 0 and grid levels 0 and 3)
    of the kernel alone, of the whole backward call (kernel and its
    matmuls), of the plain version's autograd and of the library
    composition's autograd backward, and both bounds;
15. windowed training (this slice's main path): the
    configs/train_dancetrack_windowed.yaml model in bfloat16 through the
    Trainer on the phase-12 clips, 3 steps at T=2 and 1 at T=5; finite
    losses and gradient norm, every trainable parameter reached, the frozen
    ones untouched, 12 T forward and 12 T backward K2 launches and 6 T of
    each K1 a step; ms per step, peak memory; a profiled T=2 step with K2
    backward as its own family, and the idle share;
16. hybrid training: 2 steps at T=2, the same checks, 6 T K2 and 12 T K1
    launches (forward and backward) a step;
17. one float32 windowed training step (T=1, TF32 off) through the kernels
    and through the plain K1 and K2, on ``scaled_weights_``: total loss
    and gradient norms compared (the norms to 5e-3:
    WINDOWED_TRAIN_NORM_RTOL says why);
20. conv: configs/train_dancetrack.yaml with ENCODER_TYPE conv, 4 frames
    through both loops as in phase 5 (6 K1 launches a frame), then one T=2
    training step at 896x1536 (6 T K1 forward and backward launches);
Phases run in the order 1-10, 18, 19, 11-17, 20; then a JSON line of
kernel results, the card's name and power limit and, last, the device line
``{"ok": true, "device": {...}}``.

There is no CPU path: without a CUDA device the script exits nonzero.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

ENC_SHAPES = ((100, 192), (50, 96), (25, 48), (13, 24))   # 800x1536 / 8..64
K1_SRC = "memotr_tpu_torch/csrc/msda_fwd.cu"
K1_TPU = "memotr_tpu/ops/msda_pallas.py:65"
K1B_SRC = "memotr_tpu_torch/csrc/msda_bwd.cu"
K1B_TPU = "memotr_tpu/ops/msda_pallas.py:237"
K2_SRC = "memotr_tpu_torch/csrc/window_attn_fwd.cu"
K2_TPU = "memotr_tpu/ops/window_attn.py:112"
K2B_SRC = "memotr_tpu_torch/csrc/window_attn_bwd.cu"
K2B_TPU = "memotr_tpu/ops/window_attn.py:263"
F32_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_ATOL = 2e-2
# K2 in float32: the projections (256-term sums), logits and value mix in
# float32 in another order, the logits unrounded: ~1e-6 relative per stage
K2_F32_TOL = dict(atol=1e-4, rtol=1e-4)
# K2 in bfloat16 against the plain version in float32 on the same inputs:
# the kernel rounds x + pos, the weights, Q/K/V, P.V and the output to bf16
# (5 roundings of <= 2^-9 relative on values of magnitude < ~4)
K2_BF16_ATOL = 5e-2
# one float32 frame, kernels vs plain versions: float32 sums in another
# order (~1e-6 per call), carried through the encoder, 6 decoder layers and
# the heads.  The windowed model with these seeded random weights amplifies
# a 1e-6 relative change of K2's outputs some 100-1000x in pred_logits
# (phase 8 measures it in every run), so its frame tolerance is wider; its
# K2 calls are each held at K2_F32_TOL on their own inputs.
FRAME_ATOL = {"pred_logits": 1e-3, "pred_boxes": 1e-3}
WINDOWED_FRAME_ATOL = {"pred_logits": 3e-2, "pred_boxes": 3e-2}
K2_VS_F64 = 4.0
# K1 backward against autograd of the plain version in float32 on the same
# (bf16-rounded) inputs: every gradient within 1e-5 of its largest element
# (float32 sums of up to 4 D corner products in another order; grad_value's
# float32 atomics add in a run-dependent order), grad_value in bf16 also
# rtol 8e-3 (one rounding of its float32 sum to bf16)
K1B_REL = 1e-5
K1B_BF16_VALUE_RTOL = 8e-3
# one float32 train step (T=1), kernels vs plain MSDA: float32 sums in
# another order in 12 MSDA calls, forward and backward, carried through the
# model: the loss to 1e-4 relative, the gradient norms to 1e-3.  Both
# float32 steps run on scaled_weights_, fixed for every run: on weights
# that differ from run to run (trained by the backward kernels' atomics) a
# rounding-sized difference flipped a ReLU or bilinear tap at its kink in
# about one run in four; on fixed weights every kink falls the same way in
# every run.  Five H100 runs read a largest norm change of 5.97e-6 here
# and 2.15e-4 in the windowed step, the same in each (PERF.md section 6).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_NORM_RTOL = 1e-3
# the same for the windowed model, kernels vs plain K1 and K2 (12 K2 and 6
# K1 calls, forward and backward), wider for its 12 K2 calls: on trained
# weights they read up to 1.28e-3; each K2 call is held tightly in phase 14
WINDOWED_TRAIN_NORM_RTOL = 5e-3
# K2 backward against autograd of the plain version in float32 on the same
# (bf16-rounded) inputs and cotangent, every gradient within a share of its
# largest element.  Float32: sums over L keys, the map's tokens and C
# channels in another order, the bias table's float32 atomics in a
# run-dependent order.  bfloat16: the kernel path rounds Q, K, V, dO, the
# projection gradients dQ/dK/dV and g_x/g_pos to bf16 (2^-9 relative each),
# and dS = P (dP - rowsum(P dP)) cancels, so a rounding of dP shows larger
# in dS.
K2B_F32_REL = 1e-4
K2B_BF16_REL = 3e-2
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s, bf16
# tensor-core FLOP/s, float32 CUDA-core FLOP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

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
# configs/train_dancetrack_windowed.yaml: the same fields but these
WINDOWED_CONFIG = dict(
    CONFIG, NUM_ENC_LAYERS=3, ENCODER_TYPE="windowed", WINDOW_SIZE=8,
    WINDOWED_LEPE=True, WINDOWED_BOTTOMUP=True, WINDOWED_RELPOS=True,
    WINDOWED_PRENORM=False, EVAL_CACHE=True)
HYBRID_CONFIG = dict(CONFIG, ENCODER_TYPE="hybrid")
# configs/train_dancetrack.yaml, the fields the training slice reads
TRAIN_CONFIG = dict(
    CONFIG, MAX_GTS=128, AUX_LOSS=True, AUX_LOSS_WEIGHT=[1.0] * 5,
    DROPOUT=0.0, USE_CHECKPOINT=False, LR=2.0e-4, LR_BACKBONE=2.0e-5,
    LR_POINTS=1.0e-5, WEIGHT_DECAY=5.0e-4, CLIP_MAX_NORM=0.1,
    LR_SCHEDULER="MultiStep", LR_DROP_RATE=0.1, LR_DROP_MILESTONES=[12],
    EPOCHS=20, ONLY_TRAIN_QUERY_UPDATER_AFTER=20, TP_DROP_RATE=0.0,
    FP_INSERT_RATE=0.0, NO_GRAD_FRAMES=None, ACCUMULATION_STEPS=1,
    MATCH_COST_CLASS=2, MATCH_COST_BBOX=5, MATCH_COST_GIOU=2,
    LOSS_WEIGHT_FOCAL=2, LOSS_WEIGHT_L1=5, LOSS_WEIGHT_GIOU=2)
# configs/train_dancetrack_windowed.yaml's training fields are those of
# configs/train_dancetrack.yaml; the hybrid model is the latter's with
# ENCODER_TYPE hybrid
WINDOWED_TRAIN_CONFIG = dict(
    TRAIN_CONFIG, NUM_ENC_LAYERS=3, ENCODER_TYPE="windowed", WINDOW_SIZE=8,
    WINDOWED_LEPE=True, WINDOWED_BOTTOMUP=True, WINDOWED_RELPOS=True,
    WINDOWED_PRENORM=False)
HYBRID_TRAIN_CONFIG = dict(TRAIN_CONFIG, ENCODER_TYPE="hybrid")
TRAIN_STEPS = (2, 2, 2, 5)   # SAMPLE_LENGTHS[0], then the last stage's
HYBRID_TRAIN_STEPS = (2, 2)
# the largest frame MOTR_SCALES gives a 1920x1080 video at max_size 1536
# (864x1536), on its 128-bucketed canvas
TRAIN_VALID = (864, 1536)
TRAIN_CANVAS = (896, 1536)
TRAIN_ENC_SHAPES = ((112, 192), (56, 96), (28, 48), (14, 24))
IMAGENET_MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
IMAGENET_STD = np.asarray((0.229, 0.224, 0.225), np.float32)
N_FRAMES = 8
N_HYBRID_FRAMES = 2
# the batched serving path (SUBMIT_BATCH 2): two lanes of unequal length;
# at float32 (TF32 off) each lane's ids equal its B=1 run's and its boxes
# agree to FRAME_ATOL["pred_boxes"] of the frame's size (float32 sums of
# another batch size, as phase 6 holds kernels vs plain on one frame);
# frames/s in bf16 over N_FPS_FRAMES a lane.  The float32 check runs on
# scaled_weights_ (whose float32 results are stable to another summation
# order), whose detection scores lie around 0.2-0.7: at BATCH_THRESH for
# the detection, track and result thresholds, tracks are born, kept and
# dropped in both models
BATCH_LANES = (6, 4)
BATCH_THRESH = 0.3
N_FPS_FRAMES = 10
N_MOTION_FRAMES = 4
# configs/train_dancetrack.yaml with ENCODER_TYPE conv (6 conv layers)
CONV_CONFIG = dict(CONFIG, ENCODER_TYPE="conv")
CONV_TRAIN_CONFIG = dict(TRAIN_CONFIG, ENCODER_TYPE="conv")
N_CONV_FRAMES = 4
CANVAS = (800, 1536)
ORI_HW = (720, 1440)         # resizes to 768x1536: the last 32 rows are pad
RESIZED = (768, 1536)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def median_ms(fn, runs: int = 20) -> float:
    """Median time of one call between two CUDA events: the call as its
    caller sees it, the wrapper's host work (checks, allocation, the ctypes
    call) on an idle stream included."""
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


def timed(fn, runs: int = 20) -> tuple:
    """(event ms, device ms, device_ms_by_kernel's parts) per call.  The
    device time is the sum of the self device time of every CUDA kernel
    the call runs (torch.profiler), over ``runs`` calls: the kernels alone,
    without the host's share."""
    event_ms = median_ms(fn, runs)             # warms up as well
    parts = device_ms_by_kernel(fn, runs)
    assert parts, "the profiler recorded no CUDA kernel"
    return event_ms, sum(ms for ms, _ in parts.values()), parts


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(least time in ms, "bytes" or "operations") on an H100 SXM."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


# ------------------------------------------------------------------ build
def phase_build():
    from memotr_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build("msda_fwd", "msda_bwd", "window_attn_fwd",
                         "window_attn_bwd")
    say("2 build", f"msda_fwd, msda_bwd, window_attn_fwd and window_attn_bwd "
        f"(nvcc, sm_90a, in parallel) in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        entry = None
        for line in (path.parent / "build.log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and entry:
                spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                say("2 build", f"ptxas {name}: {entry}: {m.group(1)} "
                    f"registers, {spills}")
                entry = None


# ------------------------------------------------------------------- K1
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


def msda_bound(value, loc, aw):
    b, _, m, d = value.shape
    lq, nl, p = loc.shape[1], loc.shape[3], loc.shape[4]
    nbytes = (value.numel() * value.element_size() + loc.numel() * 4
              + aw.numel() * 4 + b * lq * m * d * value.element_size())
    # per sample and channel: 4 corner multiply-adds and the weight, in f32
    flops = b * lq * m * nl * p * d * 10
    return bound(nbytes, flops, torch.float32)


def msda_gathered_bytes(value, loc):
    """Bytes of the corner rows one call reads: 4 corners of D channels for
    every (batch, query, head, level, point), out-of-bounds ones included."""
    b, lq, m, nl, p = loc.shape[:5]
    return b * lq * m * nl * p * 4 * value.shape[3] * value.element_size()


def phase_k1(device):
    """K1 vs plain version on the card; returns (max f32 error, times)."""
    from memotr_tpu_torch.ops import msda_cuda
    from memotr_tpu_torch.ops.msda import ms_deform_attn_torch as plain
    lq_enc = sum(h * w for h, w in ENC_SHAPES)
    cases = [("encoder", 1, ENC_SHAPES, 8, 32, 4, lq_enc),
             ("encoder_b2", 2, ENC_SHAPES, 8, 32, 4, lq_enc),
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
                say("3 K1", f"{name} B={b} Lq={lq} M={m} D={d} P={p} "
                    f"L={len(shapes)} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                    f"({tol}) ok")
            if name != "awkward":
                v, loc, aw = msda_inputs(1, b, shapes, m, d, p, lq,
                                         torch.bfloat16, device)
                k_ms, k_dev, _ = timed(lambda: msda_cuda.ms_deform_attn_cuda(
                    v, shapes, loc, aw))
                p_ms, p_dev, _ = timed(lambda: plain(v, shapes, loc, aw))
                b_ms, b_by = msda_bound(v, loc, aw)
                gathered = msda_gathered_bytes(v, loc)
                times[name] = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                                   plain_device_ms=p_dev, bound_ms=b_ms,
                                   bound_by=b_by)
                say("3 K1", f"{name} bf16, per call over 20: kernel device "
                    f"{k_dev:.4f} ms (event-timed call {k_ms:.4f} ms), plain "
                    f"device {p_dev:.4f} ms (call {p_ms:.4f} ms), bound "
                    f"{b_ms:.4f} ms ({b_by}); corner rows gathered "
                    f"{gathered / 1e6:.1f} MB, achieved "
                    f"{gathered / k_dev / 1e6:.1f} GB/s (device time)")
    return worst, times


# ------------------------------------------------------------------- K2
def canvas_mask(device, canvas=CANVAS, valid=RESIZED) -> torch.Tensor:
    """(1, H, W) padding mask of the synthetic frames: the streaming
    800x1536 canvas (768x1536 valid), or the training canvas."""
    mask = torch.ones((1,) + canvas, dtype=torch.bool, device=device)
    mask[:, :valid[0], :valid[1]] = False
    return mask


# K2's named cases: (pyramid level, grid attention, batch); "_b2" are the
# batched serving lanes' shapes (SUBMIT_BATCH 2, one canvas)
K2_CASES = {"window_l0": (0, False, 1), "grid_l0": (0, True, 1),
            "grid_l1": (1, True, 1), "grid_l2": (2, True, 1),
            "grid_l3": (3, True, 1), "window_l0_b2": (0, False, 2),
            "grid_l0_b2": (0, True, 2)}


def k2_case(name, dtype, device, seed=0, train=False):
    """(args, (heads, window_h, window_w)) of a window_attention call: the
    main path's level maps (C=256, 8 heads, window 8) of the 800x1536
    streaming canvas, or with ``train`` of the 896x1536 training canvas,
    padded to window multiples with the canvas's mask, at batch 1 or 2
    (``K2_CASES``), or an awkward one."""
    from memotr_tpu_torch.models.memotr import _downsample_mask
    from memotr_tpu_torch.ops.window_attn import grid_transpose
    rng = np.random.default_rng(seed)
    shapes, canvas = ((TRAIN_ENC_SHAPES, (TRAIN_CANVAS, TRAIN_VALID)) if train
                      else (ENC_SHAPES, (CANVAS, RESIZED)))
    if name == "awkward":
        b, heads, win = 2, 4, 4
        mask = torch.zeros((b, 16, 24), dtype=torch.bool, device=device)
        mask[:, :, 21:] = True
        mask[1, :win, :win] = True             # a fully padded window
        grid, with_bias = False, False
    else:
        heads, win = 8, 8
        lvl, grid, b = K2_CASES[name]
        h, w = shapes[lvl]
        mask = _downsample_mask(canvas_mask(device, *canvas), h, w)
        mask = F.pad(mask, (0, (-w) % win, 0, (-h) % win), value=True)
        mask = mask.expand(b, -1, -1).contiguous()
        with_bias = True
    c = 32 if name == "awkward" else 256
    hp, wp = mask.shape[1:]
    wh, ww = (hp // win, wp // win) if grid else (win, win)
    l = wh * ww

    def dev(shape, scale):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(device)
    x, pos = dev((b, hp, wp, c), 1.0).to(dtype), dev((b, hp, wp, c), 0.5).to(dtype)
    if grid:
        x, pos, mask = (grid_transpose(t, win).contiguous()
                        for t in (x, pos, mask))
    args = (x, pos, mask, dev((3 * c, c), c ** -0.5), dev((3 * c,), 0.1),
            dev((c, c), c ** -0.5), dev((c,), 0.1),
            dev((heads, l, l), 0.3) if with_bias else None)
    return args, (heads, wh, ww)


def library_window_attention(x, pos, mask, in_w, in_b, out_w, out_b, bias,
                             heads, wh, ww):
    """The yardstick: K2's function as a composition of library calls
    (partition, three torch.matmul, scaled_dot_product_attention with the
    bias and key mask as attn_mask, torch.matmul, merge).  Timed only."""
    b, h, w, c = x.shape
    l, dh, dt = wh * ww, c // heads, x.dtype

    def part(t):
        t = t.reshape(b, h // wh, wh, w // ww, ww, -1)
        return t.permute(0, 1, 3, 2, 4, 5).reshape(-1, l, t.shape[-1])
    q, v = part(x + pos), part(x)
    m = part(mask[..., None]).squeeze(-1)
    m = m & ~m.all(dim=1, keepdim=True)
    wq, wk, wv = in_w.to(dt).chunk(3)
    bq, bk, bv = in_b.to(dt).chunk(3)
    heads_of = lambda t: t.view(-1, l, heads, dh).transpose(1, 2)  # noqa: E731
    qh = heads_of(torch.matmul(q, wq.t()) + bq)
    kh = heads_of(torch.matmul(q, wk.t()) + bk)
    vh = heads_of(torch.matmul(v, wv.t()) + bv)
    attn_mask = torch.zeros((1, 1, l, l), dtype=dt, device=x.device) \
        if bias is None else bias[None].to(dt)
    attn_mask = attn_mask.masked_fill(m[:, None, None, :], float("-inf"))
    o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=attn_mask)
    y = torch.matmul(o.transpose(1, 2).reshape(-1, l, c), out_w.to(dt).t()) \
        + out_b.to(dt)
    y = y.reshape(b, h // wh, w // ww, wh, ww, c)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def k2_flops(args, geo):
    """Multiply-adds x 2 of the four projections and the two attention
    products over every (padded) token."""
    b, h, w, c = args[0].shape
    tokens, l = b * h * w, geo[1] * geo[2]
    return 8 * c * c * tokens + 4 * l * c * tokens


def k2_bound(args, geo):
    x, bias = args[0], args[7]
    c = x.shape[3]
    tokens = x.numel() // c
    nbytes = (3 * tokens * c * x.element_size() + tokens
              + (4 * c * c + 4 * c) * 4
              + (bias.numel() * 4 if bias is not None else 0))
    return bound(nbytes, k2_flops(args, geo), x.dtype)


def phase_k2(device):
    """K2 vs plain version on the card; returns (max f32 error, times)."""
    from memotr_tpu_torch.ops import window_attn_cuda
    from memotr_tpu_torch.ops.window_attn import window_attention_torch
    from memotr_tpu_torch.ops.window_attn_cuda import window_attention_cuda
    worst = 0.0
    times = {}
    with torch.inference_mode():
        for name in ("window_l0", "grid_l0", "grid_l3", "window_l0_b2",
                     "grid_l0_b2", "awkward"):
            for dtype in (torch.float32, torch.bfloat16):
                args, geo = k2_case(name, dtype, device)
                out = window_attention_cuda(*args, *geo)
                ref = window_attention_torch(args[0].float(),
                                             args[1].float(), *args[2:],
                                             *geo)
                torch.cuda.synchronize()
                assert torch.isfinite(out).all(), (name, dtype)
                err = (out.float() - ref).abs().max().item()
                if dtype == torch.float32:
                    torch.testing.assert_close(out, ref, **K2_F32_TOL)
                    worst = max(worst, err)
                    tol = (f"atol {K2_F32_TOL['atol']} rtol "
                           f"{K2_F32_TOL['rtol']}")
                else:
                    assert err <= K2_BF16_ATOL, (name, err)
                    tol = f"atol {K2_BF16_ATOL} vs plain f32 on bf16 inputs"
                x = args[0]
                say("4 K2", f"{name} x {tuple(x.shape)} window {geo[1]}x"
                    f"{geo[2]} (L={geo[1] * geo[2]}) heads {geo[0]} bias "
                    f"{args[7] is not None} {str(dtype)[6:]}: max_abs_err "
                    f"{err:.3e} ({tol}) ok")
            if name == "awkward":
                continue
            args, geo = k2_case(name, torch.bfloat16, device, seed=1)
            fused_before = window_attn_cuda.routes["fused"]
            lib = library_window_attention(*args, *geo)
            ref = window_attention_torch(args[0].float(), args[1].float(),
                                         *args[2:], *geo)
            lib_err = (lib.float() - ref).abs().max().item()
            assert lib_err <= K2_BF16_ATOL, ("library", name, lib_err)
            k_ms, k_dev, parts = timed(
                lambda: window_attention_cuda(*args, *geo))
            assert window_attn_cuda.routes["fused"] > fused_before, \
                f"{name}: bf16 at C=256, head dim 32 did not take the fused route"
            p_ms, p_dev, _ = timed(lambda: window_attention_torch(*args, *geo))
            l_ms, l_dev, _ = timed(
                lambda: library_window_attention(*args, *geo))
            b_ms, b_by = k2_bound(args, geo)
            flops = k2_flops(args, geo)
            times[name] = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                               plain_device_ms=p_dev, library_ms=l_ms,
                               library_device_ms=l_dev, bound_ms=b_ms,
                               bound_by=b_by)
            say("4 K2", f"{name} bf16, per call over 20: kernel device "
                f"{k_dev:.4f} ms (event-timed call {k_ms:.4f} ms), plain "
                f"device {p_dev:.4f} ms (call {p_ms:.4f}), library "
                f"composition device {l_dev:.4f} ms (call {l_ms:.4f}; its "
                f"max_abs_err {lib_err:.3e}), bound {b_ms:.4f} ms ({b_by}); "
                f"achieved {flops / k_dev / 1e9:.1f} TFLOP/s (device time), "
                f"{b_ms / k_dev:.1%} of the bound")
            say("4 K2", f"{name} bf16 device time by CUDA kernel (profiler, "
                f"20 calls): " + ", ".join(
                    f"{kernel_name(k)} {ms:.4f} ms ({n} launches)"
                    for k, (ms, n) in parts.items()))
    return worst, times


def kernel_name(key: str) -> str:
    """``void (anonymous namespace)::f<T>(args)`` -> ``f<T>``."""
    m = re.search(r"(\w+(?:<[^>]*>)?)\(", key)
    return m.group(1) if m else key


def device_ms_by_kernel(fn, calls: int = 10) -> dict:
    """{kernel: (mean device ms per call, launches recorded)} of every CUDA
    kernel that ``calls`` calls of ``fn`` run.  The profiler now and then
    drops a few device events (its activity buffer is not flushed): so a
    kernel's time per call is its mean time per recorded launch times its
    launches per call (recorded launches / calls, rounded), and a profiling
    run that recorded no device event at all is run again, at most twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                per_call = max(1, round(e.count / calls))
                parts[e.key] = (e.self_device_time_total / 1e3 / e.count
                                * per_call, e.count)
        if parts:
            return parts
    return {}


# ---------------------------------------------------------------- slices
def synthetic_frames(n_frames: int, seed: int = 0):
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
    for t in range(n_frames):
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


def _seeded_buffers_(model, g: torch.Generator):
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if "running_var" in name:
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
            else:
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.3
                          + (1.0 if "weight" in name else 0.0))


def random_weights_(model, seed: int = 7):
    """Every parameter and buffer drawn from a seeded generator, as the JAX
    package's reference-parity test draws them; then norms around one and
    unit-scale detection queries, which keep the 300 queries distinct so
    that their scores spread around the thresholds and detections fire."""
    g = torch.Generator().manual_seed(seed)
    _seeded_buffers_(model, g)
    with torch.no_grad():
        for _, p in model.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.08)
        for mod in model.modules():
            if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                mod.weight.add_(1.0)
        model.det_query_embed.mul_(12.5)
        model.det_anchor.mul_(12.5)
    return model


def scaled_weights_(model, seed: int = 7):
    """Every parameter and buffer drawn from a seeded generator, each
    weight matrix or kernel at std 1/sqrt(fan_in) (the scale at which
    activations and gradients keep their size through depth, as the
    model's own initialisation has it), vectors (biases) at std 0.02,
    norms' scales around one, and unit-scale detection queries as in
    ``random_weights_`` (so that detections fire); buffers as
    ``random_weights_`` draws them.  ``random_weights_`` draws every
    parameter at std 0.08, which grows the ResNet's activations ~5x a
    3x3 conv: fine for streaming, but its float32 gradients are too
    rough to compare two summation orders (PERF.md section 6, F3)."""
    g = torch.Generator().manual_seed(seed)
    _seeded_buffers_(model, g)
    with torch.no_grad():
        for _, p in model.named_parameters():
            std = p[0].numel() ** -0.5 if p.dim() >= 2 else 0.02
            p.copy_(torch.randn(p.shape, generator=g) * std)
        for mod in model.modules():
            if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                mod.weight.add_(1.0)
        for p in (model.det_query_embed, model.det_anchor):
            p.copy_(torch.randn(p.shape, generator=g))
    return model


def reset_counts():
    from memotr_tpu_torch.ops import msda_cuda, window_attn_cuda
    msda_cuda.launches = 0
    msda_cuda.bwd_launches = 0
    window_attn_cuda.launches = 0
    window_attn_cuda.bwd_launches = 0


def read_counts():
    from memotr_tpu_torch.ops import msda_cuda, window_attn_cuda
    return {"msda_fwd": msda_cuda.launches,
            "msda_bwd": msda_cuda.bwd_launches,
            "window_attn_fwd": window_attn_cuda.launches,
            "window_attn_bwd": window_attn_cuda.bwd_launches}


def checked_submitter(*args, **kwargs):
    """The port's Submitter, checking each frame's host results before
    writing them (``live``: the live slots of each frame)."""
    from memotr_tpu_torch.engine.submit import Submitter

    class CheckedSubmitter(Submitter):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.live = []

        def _write_frame(self, i, results, ori_hw, path, bdd_results):
            for key in ("boxes", "scores"):
                assert np.isfinite(results[key]).all(), (i, key)
            self.live.append(int(results["mask"].sum()))
            super()._write_frame(i, results, ori_hw, path, bdd_results)
    return CheckedSubmitter(*args, **kwargs)


def steady_ms(seconds, skip: int = 2) -> np.ndarray:
    """Per-frame ms from frame ``skip + 1`` on (the first frames build the
    eval cache and warm the allocator)."""
    ms = 1e3 * np.asarray(seconds)
    return ms[skip:] if len(ms) > skip else ms


def stream(tag, model, config, frames, device, loop="pipelined",
           no_sync=False):
    """Streams ``frames`` through a checked Submitter with the given loop;
    the launch counts are set to 0 just before and read just after.  With
    ``no_sync`` the run is under torch.cuda.set_sync_debug_mode("error"):
    any synchronizing CUDA call (a device-to-host copy, an item(), a
    pageable upload, a stream synchronize) raises.  The host seconds of
    each frame step's call (normalize, forward, lifecycle, updater, all
    asynchronous: the dispatch) go to ``sub.dispatch``.  Returns
    (submitter, counts, MOT txt, wall seconds)."""
    with tempfile.TemporaryDirectory() as out_dir:
        sub = checked_submitter("DanceTrack", frames, "synthetic", out_dir,
                                model, config, device)
        step, sub.dispatch = sub._step, []

        def timed_step(*args):
            t0 = time.perf_counter()
            out = step(*args)
            sub.dispatch.append(time.perf_counter() - t0)
            return out
        sub._step = timed_step
        if loop == "sync":
            sub.pipelined = False
        assert sub.pipelined == (loop == "pipelined"), (tag, loop)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        if no_sync:
            torch.cuda.set_sync_debug_mode("error")
        try:
            sub.run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        with open(os.path.join(out_dir, "tracker", "synthetic.txt")) as f:
            txt = f.read()
    return sub, counts, txt, wall


def phase_slice(tag, config, n_frames, per_frame, device, live="first"):
    """Streams ``n_frames`` synthetic frames of ``config`` through the
    Submitter's pipelined loop (its default) with no host sync allowed,
    then through its sync loop: the MOT txt byte-identical and the launch
    counts equal.  Checks each kernel's launches per frame (``per_frame``),
    finite results and, unless ``live`` is None, live tracks in the first
    (``"first"``) or some (``"any"``) frame and a non-empty MOT txt; prints
    each loop's steady ms/frame.  Returns the model and the launch counts
    of the pipelined run."""
    from memotr_tpu_torch.models.memotr import build_model

    model = random_weights_(build_model(config)).to(device).eval()
    runs = {loop: stream(tag, model, config, synthetic_frames(n_frames),
                         device, loop, no_sync=loop == "pipelined")
            for loop in ("pipelined", "sync")}
    sub, counts, txt, _ = runs["pipelined"]
    lines = txt.splitlines()
    assert len(sub.live) == n_frames, sub.live
    say(tag, "pipelined loop under torch.cuda.set_sync_debug_mode('error'): "
        "no synchronizing CUDA call in the dispatch, prefetch or writer "
        "thread ok")
    for kernel, n in per_frame.items():
        assert counts[kernel] == n * n_frames, \
            f"{kernel} launches {counts[kernel]}, expected {n} x {n_frames}"
        say(tag, f"{kernel} launches {counts[kernel]} = {n} x {n_frames} "
            f"frames ok")
    if live is not None:
        assert (sub.live[0] if live == "first" else max(sub.live)) > 0, \
            f"no live track: {sub.live}"
        assert lines, "empty MOT txt"
    say(tag, f"live slots per frame {sub.live}; MOT txt lines {len(lines)}"
        + (f"; first line {lines[0].strip()}" if lines else ""))
    _, sync_counts, sync_txt, _ = runs["sync"]
    assert sync_txt == txt, f"{tag}: the sync loop's MOT txt differs"
    assert sync_counts == counts, (sync_counts, counts)
    say(tag, f"sync loop on the same frames: MOT txt byte-identical "
        f"({len(txt)} bytes) and the same launch counts ok")
    for loop, (s, _, _, wall) in runs.items():
        ms = steady_ms(s.frame_seconds)
        say(tag, f"bf16 {loop} ms/frame ("
            + ("upload, step, fetch" if loop == "sync" else
               "between completions in the writer")
            + f"), frames 3-{n_frames}: mean {ms.mean():.2f} median "
            f"{np.median(ms):.2f} min {ms.min():.2f} max {ms.max():.2f}; "
            f"of it the host dispatch of the frame step mean "
            f"{steady_ms(s.dispatch).mean():.2f}; "
            f"all frames {[round(float(v), 2) for v in 1e3 * np.asarray(s.frame_seconds)]}; "
            f"run wall {1e3 * wall:.1f} ms")
    return model, counts


def phase_frame_f32(tag, config, model_bf16, device, frame_atol):
    """One float32 frame through the kernels and through the plain
    versions of every kernel the model runs.  Each K2 call of the kernel
    run is also held against the plain version on its own inputs."""
    from memotr_tpu_torch.engine.submit import normalize_uint8
    from memotr_tpu_torch.models import msda_module, windowed_encoder
    from memotr_tpu_torch.models.frame_step import model_forward
    from memotr_tpu_torch.models.memotr import build_model
    from memotr_tpu_torch.ops.msda import ms_deform_attn_torch
    from memotr_tpu_torch.ops.window_attn import window_attention_torch
    from memotr_tpu_torch.ops.window_attn_cuda import window_attention_cuda
    from memotr_tpu_torch.structures.track_state import TrackState

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(tag, "TF32 off for convs (cudnn.allow_tf32=False) and matmuls "
        "(cuda.matmul.allow_tf32=False)")
    model = build_model(dict(config, DTYPE="float32"))
    model.load_state_dict(model_bf16.state_dict())
    model.to(device).eval()
    fr = next(synthetic_frames(1, seed=1))
    images = normalize_uint8(torch.from_numpy(fr["image"])[None].to(device))
    mask = torch.from_numpy(fr["mask"])[None].to(device)
    state = TrackState.empty(1, config["TRACK_SLOTS"], config["HIDDEN_DIM"],
                             1, device=device)
    calls = []

    def k2_checked(*args):
        """The kernel, held against float64 beside the plain version."""
        out = window_attention_cuda(*args)
        ref = window_attention_torch(*args)
        exact = window_attention_torch(*(
            a.double() if torch.is_tensor(a) and a.is_floating_point() else a
            for a in args))
        e_kern = (out.double() - exact).abs().max().item()
        e_plain = (ref.double() - exact).abs().max().item()
        assert e_kern <= K2_VS_F64 * e_plain + 1e-6, (e_kern, e_plain)
        calls.append((args[-2] * args[-1], e_kern, e_plain))
        return out

    kernels = (msda_module.ms_deform_attn, windowed_encoder.window_attention)
    with torch.inference_mode():
        windowed_encoder.window_attention = k2_checked
        try:
            kern = model_forward(model, images, mask, state)
            msda_module.ms_deform_attn = ms_deform_attn_torch
            windowed_encoder.window_attention = window_attention_torch
            plain = model_forward(model, images, mask, state)
            if calls:
                g = torch.Generator(device).manual_seed(0)

                def k2_perturbed(*args):
                    y = window_attention_torch(*args)
                    return y * (1 + 1e-6 * torch.randn(
                        y.shape, generator=g, device=device))
                windowed_encoder.window_attention = k2_perturbed
                nudged = model_forward(model, images, mask, state)
        finally:
            msda_module.ms_deform_attn, windowed_encoder.window_attention = \
                kernels
    torch.cuda.synchronize()
    if calls:
        say(tag, "sensitivity: plain versions with K2 outputs x (1 + 1e-6 "
            "N(0,1)) move pred_logits by "
            f"{(nudged['pred_logits'] - plain['pred_logits']).abs().max().item():.3e}"
            " and pred_boxes by "
            f"{(nudged['pred_boxes'] - plain['pred_boxes']).abs().max().item():.3e}")
        say(tag, f"{len(calls)} K2 calls in the frame (L = "
            f"{sorted({c[0] for c in calls})}), each on its own inputs vs "
            f"float64: kernel max_abs_err {max(c[1] for c in calls):.3e}, "
            f"plain float32 {max(c[2] for c in calls):.3e} (kernel <= "
            f"{K2_VS_F64} x plain + 1e-6 per call) ok")
    for key, atol in frame_atol.items():
        assert torch.isfinite(kern[key]).all(), key
        err = (kern[key] - plain[key]).abs().max().item()
        assert err <= atol, f"{key}: kernel vs plain max_abs_err {err} > {atol}"
        say(tag, f"{key} {tuple(kern[key].shape)} kernels vs plain "
            f"max_abs_err {err:.3e} (atol {atol}) ok")


def kernel_family(name: str) -> str:
    n = name.lower()
    if "attn_bwd" in n:
        return "K2 window_attn_bwd"
    if "proj_kernel" in n or "attn_kernel" in n:
        return "K2 window_attn_fwd"
    if "msda_fwd" in n:
        return "K1 msda_fwd"
    if "msda_bwd" in n:
        return "K1 msda_bwd"
    # cuDNN's implicit-GEMM convolutions carry GEMM-like names too
    if any(k in n for k in ("conv", "cudnn", "implicit", "fprop", "dgrad",
                            "wgrad")):
        return "convolution"
    if any(k in n for k in ("gemm", "nvjet", "xmma", "cutlass", "sm90_")):
        return "GEMM"
    if "norm" in n:
        return "normalization"
    return "elementwise, copies, reductions"


def phase_profile(model, config, device, n_frames: int = 3):
    """Windowed frames after two warm-up frames: timed, then the same
    frames again under torch.profiler for device time by kernel family."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from memotr_tpu_torch.engine.submit import normalize_uint8
    from memotr_tpu_torch.models.eval_cache import EvalCache
    from memotr_tpu_torch.models.frame_step import eval_frame_step
    from memotr_tpu_torch.structures.track_state import TrackState

    cache = EvalCache(model, device)
    state = TrackState.empty(1, config["TRACK_SLOTS"], config["HIDDEN_DIM"],
                             1, device=device)
    frames = list(synthetic_frames(2 + n_frames, seed=2))
    frames += frames[2:]                 # the timed frames, again profiled

    def step(fr, state):
        images = normalize_uint8(torch.from_numpy(fr["image"])[None]
                                 .to(device))
        ctx = cache.lookup(fr["mask"][None])
        mask = torch.from_numpy(fr["mask"])[None].to(device)
        results, state = eval_frame_step(
            model, images, mask, state, config["DET_SCORE_THRESH"],
            config["TRACK_SCORE_THRESH"], config["MISS_TOLERANCE"], ctx)
        for v in results.values():               # fetch, as the Submitter
            v.cpu()
        return state

    with torch.inference_mode():
        for fr in frames[:2]:
            state = step(fr, state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for fr in frames[2:2 + n_frames]:
            state = step(fr, state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_frames
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for fr in frames[2 + n_frames:]:
                state = step(fr, state)
            torch.cuda.synchronize()
            wall_prof = (time.perf_counter() - t0) * 1e3 / n_frames
    fam = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            k = kernel_family(e.key)
            fam[k] = fam.get(k, 0.0) + e.self_device_time_total / 1e3 / n_frames
    busy = sum(fam.values())
    say("9 profile", f"windowed bf16, {n_frames} frames: host wall "
        f"{wall:.2f} ms/frame ({wall_prof:.2f} under the profiler), device "
        f"busy {busy:.2f} ms/frame (profiler), idle share of the unprofiled "
        f"wall {1 - busy / wall:.3f}")
    for k, v in sorted(fam.items(), key=lambda kv: -kv[1]):
        say("9 profile", f"  {k}: {v:.3f} ms/frame ({v / busy:.1%} of busy)")
    assert fam.get("K2 window_attn_fwd", 0) > 0, "no K2 time in the trace"


# ------------------------------------------------------------ K1 backward
def plain_msda_grads(v, shapes, loc, aw, g):
    """Autograd of the plain version: (grad_value, grad_loc, grad_aw)."""
    from memotr_tpu_torch.ops.msda import ms_deform_attn_torch as plain
    v, loc, aw = (t.detach().clone().requires_grad_() for t in (v, loc, aw))
    return torch.autograd.grad(plain(v, shapes, loc, aw), (v, loc, aw), g)


def msda_bwd_bound(value, loc, aw):
    """Bytes: value, loc, aw and grad_out read once, the three gradients
    written once (grad_value in the value dtype).  Operations, per sample
    and channel in float32: the sample again (8), grad_aw (2), grad_loc
    (2 x 7) and the four corners' scaled adds (8)."""
    b, _, m, d = value.shape
    lq, nl, p = loc.shape[1], loc.shape[3], loc.shape[4]
    es = value.element_size()
    nbytes = (2 * value.numel() * es + 2 * (loc.numel() + aw.numel()) * 4
              + b * lq * m * d * es)
    return bound(nbytes, b * lq * m * nl * p * d * 32, torch.float32)


def phase_k1_bwd(device):
    """K1 backward vs the plain version's autograd on the card; returns
    (max f32 error, times at the encoder shape)."""
    from memotr_tpu_torch.ops import msda_cuda
    from memotr_tpu_torch.ops.msda import ms_deform_attn_torch as plain
    lq_enc = sum(h * w for h, w in TRAIN_ENC_SHAPES)
    cases = [("encoder", 1, lq_enc), ("decoder_b1", 1, 364),
             ("decoder_b2", 2, 364)]
    worst, times = 0.0, {}
    gen = torch.Generator(device).manual_seed(0)
    for name, b, lq in cases:
        shapes = TRAIN_ENC_SHAPES
        for dtype in (torch.float32, torch.bfloat16):
            v, loc, aw = msda_inputs(0, b, shapes, 8, 32, 4, lq, dtype,
                                     device)
            g = torch.randn((b, lq, 256), generator=gen,
                            device=device).to(dtype)
            before = msda_cuda.bwd_launches
            got = msda_cuda.msda_backward(v, shapes, loc, aw, g)
            assert msda_cuda.bwd_launches == before + 1
            want = plain_msda_grads(v.float(), shapes, loc, aw, g.float())
            torch.cuda.synchronize()
            errs = []
            for gname, x, y in zip(("value", "loc", "aw"), got, want):
                assert torch.isfinite(x).all(), (name, dtype, gname)
                diff = (x.float() - y).abs()
                rtol = K1B_BF16_VALUE_RTOL if (
                    gname == "value" and dtype == torch.bfloat16) else 0.0
                lim = K1B_REL * y.abs().max().item() + 1e-7 + rtol * y.abs()
                assert bool((diff <= lim).all()), \
                    (name, dtype, gname, diff.max().item())
                errs.append(diff.max().item())
            if dtype == torch.float32:
                worst = max(worst, *errs)
            say("11 K1 bwd", f"{name} B={b} Lq={lq} {str(dtype)[6:]}: "
                f"max_abs_err grad_value {errs[0]:.3e}, grad_loc "
                f"{errs[1]:.3e}, grad_aw {errs[2]:.3e} (each within "
                f"{K1B_REL} of its largest element"
                + (f", grad_value also rtol {K1B_BF16_VALUE_RTOL}"
                   if dtype == torch.bfloat16 else "")
                + "; vs plain f32 autograd on the same inputs) ok")
        v, loc, aw = msda_inputs(1, b, shapes, 8, 32, 4, lq, torch.bfloat16,
                                 device)
        g = torch.randn((b, lq, 256), generator=gen,
                        device=device).to(torch.bfloat16)
        k_ms, k_dev, parts = timed(
            lambda: msda_cuda.msda_backward(v, shapes, loc, aw, g))
        vr, lr, ar = (t.detach().clone().requires_grad_()
                      for t in (v, loc, aw))
        out = plain(vr, shapes, lr, ar)
        p_ms, p_dev, _ = timed(lambda: torch.autograd.grad(
            out, (vr, lr, ar), g, retain_graph=True))
        del out
        b_ms, b_by = msda_bwd_bound(v, loc, aw)
        kern = sum(ms for k, (ms, _) in parts.items() if "msda_bwd" in k)
        times[name] = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                           plain_device_ms=p_dev, bound_ms=b_ms,
                           bound_by=b_by, kernel_device_ms=kern)
        scattered = b * lq * 8 * 16 * 4 * 32
        say("11 K1 bwd", f"{name} bf16, per call over 20: device "
            f"{k_dev:.4f} ms (msda_bwd_kernel {kern:.4f}; the zeroed float32 "
            f"scratch and the cast to bf16 the rest; event-timed call "
            f"{k_ms:.4f} ms), plain autograd backward device {p_dev:.4f} ms "
            f"(call {p_ms:.4f}), bound {b_ms:.4f} ms ({b_by}); at most "
            f"{scattered / 1e6:.1f} M float32 atomic adds, "
            f"{scattered / kern / 1e6:.2f} G/s of kernel time")
        say("11 K1 bwd", f"{name} bf16 device time by CUDA kernel: " + ", ".join(
            f"{kernel_name(k)} {ms:.4f} ms" for k, (ms, _) in parts.items()))
    return worst, times


# ------------------------------------------------------------ K2 backward
K2B_NAMES = ("x", "pos", "in_proj_weight", "in_proj_bias", "out_weight",
             "out_bias", "bias")


def k2_leaves(args, dtype=None):
    """The differentiable inputs of a K2 call (x, pos, the four projection
    tensors, the bias table or None), detached copies that require grad
    (x and pos cast to ``dtype`` where given)."""
    out = []
    for i, a in enumerate((args[0], args[1]) + tuple(args[3:8])):
        if a is not None:
            a = a.detach().clone()
            if dtype is not None and i < 2:
                a = a.to(dtype)
            a.requires_grad_()
        out.append(a)
    return out


def k2_grads(fn, leaves, mask, geo, g):
    """The gradients of the leaves that exist, through one K2 call."""
    x, pos, in_w, in_b, out_w, out_b, bias = leaves
    out = fn(x, pos, mask, in_w, in_b, out_w, out_b, bias, *geo)
    return torch.autograd.grad(out, [t for t in leaves if t is not None], g)


def k2_bwd_bound(args, geo, whole: bool):
    """The least time of K2's backward.  Kernel alone: Q, K, V and dO read,
    dQ, dK, dV written (in the activation dtype), the mask, the bias table
    read and its gradient written; the five attention products, 10 L C
    flops a token.  Whole call: x, pos and the cotangent read, g_x and g_pos
    written, the weights read and their gradients written; the attention
    products and the VJP's projection products (16 C^2 flops a token)."""
    x, bias = args[0], args[7]
    c = x.shape[3]
    n, l, es = x.numel() // c, geo[1] * geo[2], x.element_size()
    table = 2 * bias.numel() * 4 if bias is not None else 0
    flops = 10 * n * l * c
    if whole:
        nbytes = 5 * n * c * es + n + 2 * (4 * c * c + 4 * c) * 4 + table
        flops += 16 * n * c * c
    else:
        nbytes = 7 * n * c * es + n + table
    return bound(nbytes, flops, x.dtype)


def phase_k2_bwd(device):
    """K2 backward (through WindowAttnFunction) vs the plain version's
    autograd on the card; returns (max f32 error, times at the training
    canvas's shapes)."""
    from memotr_tpu_torch.ops import window_attn_cuda as wac
    from memotr_tpu_torch.ops.window_attn import window_attention_torch
    # (name, training canvas, timed): every grid level of the training
    # canvas (L = 336, 84, 24, 6) and its window level 0 (L = 64)
    cases = [("window_l0", True, True), ("grid_l0", True, True),
             ("grid_l1", True, False), ("grid_l2", True, False),
             ("grid_l3", True, True), ("window_l0", False, False),
             ("grid_l0", False, False), ("awkward", False, False)]
    worst, times = 0.0, {}
    gen = torch.Generator(device).manual_seed(0)
    for name, train, timed_case in cases:
        where = ("896x1536" if train else "800x1536") \
            if name != "awkward" else "B=2 C=32 4 heads, a dead window"
        for dtype in (torch.float32, torch.bfloat16):
            args, geo = k2_case(name, dtype, device, seed=2, train=train)
            g = torch.randn(args[0].shape, generator=gen,
                            device=device).to(dtype)
            leaves = k2_leaves(args)
            f0, b0 = wac.launches, wac.bwd_launches
            got = k2_grads(wac.window_attention_cuda, leaves, args[2], geo,
                           g)
            assert (wac.launches, wac.bwd_launches) == (f0 + 1, b0 + 1)
            want = k2_grads(window_attention_torch,
                            k2_leaves(args, torch.float32), args[2], geo,
                            g.float())
            torch.cuda.synchronize()
            rel = K2B_F32_REL if dtype == torch.float32 else K2B_BF16_REL
            names = [k for k, t in zip(K2B_NAMES, leaves) if t is not None]
            errs = []
            for gname, a, r, leaf in zip(names, got, want,
                                         [t for t in leaves if t is not None]):
                assert a.dtype == leaf.dtype and torch.isfinite(a).all(), \
                    (name, dtype, gname)
                diff = (a.float() - r).abs().max().item()
                top = r.abs().max().item()
                assert diff <= rel * top + 1e-7, \
                    (name, dtype, gname, diff, top)
                errs.append((gname, diff, diff / max(top, 1e-30)))
                if dtype == torch.float32:
                    worst = max(worst, diff)
            say("14 K2 bwd", f"{name} {where} x {tuple(args[0].shape)} L="
                f"{geo[1] * geo[2]} bias {args[7] is not None} "
                f"{str(dtype)[6:]}: max_abs_err (share of the largest) "
                + ", ".join(f"{k} {d:.2e} ({r:.1e})" for k, d, r in errs)
                + f" (each within {rel} of its largest element; vs plain "
                "f32 autograd on the same inputs) ok")
            del got, want
        if not timed_case:
            continue
        args, geo = k2_case(name, torch.bfloat16, device, seed=3, train=True)
        g = torch.randn(args[0].shape, generator=gen,
                        device=device).to(torch.bfloat16)
        with torch.no_grad():
            _, o = wac.window_attention_fwd(*args, *geo)
        tc_before = wac.bwd_routes["tensor_cores"]
        k_ms, k_dev, parts = timed(
            lambda: wac.window_attention_bwd(g, *args, o, *geo))
        assert wac.bwd_routes["tensor_cores"] > tc_before, \
            f"{name}: bf16 at head dim 32 did not take the tensor-core route"
        kern = sum(ms for k, (ms, _) in parts.items() if "attn_bwd" in k)
        assert kern > 0, "no attn_bwd kernel in the profile"
        leaves = k2_leaves(args)
        live = [t for t in leaves if t is not None]
        out = window_attention_torch(leaves[0], leaves[1], args[2],
                                     *leaves[2:], *geo)
        p_ms, p_dev, _ = timed(lambda: torch.autograd.grad(
            out, live, g, retain_graph=True))
        out = library_window_attention(leaves[0], leaves[1], args[2],
                                       *leaves[2:], *geo)
        l_ms, l_dev, _ = timed(lambda: torch.autograd.grad(
            out, live, g, retain_graph=True))
        del out
        b_ms, b_by = k2_bwd_bound(args, geo, whole=True)
        kb_ms, kb_by = k2_bwd_bound(args, geo, whole=False)
        times[name] = dict(ms=k_ms, device_ms=k_dev, kernel_device_ms=kern,
                           plain_ms=p_ms, plain_device_ms=p_dev,
                           library_ms=l_ms, library_device_ms=l_dev,
                           bound_ms=b_ms, bound_by=b_by,
                           kernel_bound_ms=kb_ms, kernel_bound_by=kb_by)
        say("14 K2 bwd", f"{name} 896x1536 bf16 (tensor-core route), per "
            f"call over 20: whole backward device {k_dev:.4f} ms (kernel "
            f"{kern:.4f}; "
            f"event-timed call {k_ms:.4f}), plain autograd backward device "
            f"{p_dev:.4f} ms (call {p_ms:.4f}), library composition's "
            f"autograd backward device {l_dev:.4f} ms (call {l_ms:.4f}); "
            f"bound whole {b_ms:.4f} ms ({b_by}), kernel {kb_ms:.4f} ms "
            f"({kb_by}): kernel at {kb_ms / kern:.1%} of its bound")
        say("14 K2 bwd", f"{name} bf16 device time by CUDA kernel: "
            + ", ".join(f"{kernel_name(k)} {ms:.4f} ms ({n})"
                        for k, (ms, n) in sorted(parts.items(),
                                                 key=lambda kv: -kv[1][0])))
    return worst, times


# ---------------------------------------------------------------- training
def synthetic_clip(t: int, seed: int):
    """A collate_clips item: T normalized float32 frames of TRAIN_VALID
    size with 20 textured boxes moving over a textured background, ids
    kept across frames; id 0 leaves after the first half of the clip and
    id 20 enters in its second half."""
    rng = np.random.default_rng(seed)
    h, w = TRAIN_VALID
    n = 21
    bg = rng.integers(40, 140, (h, w, 3), np.uint8)
    size = rng.uniform([0.04, 0.14], [0.13, 0.42], (n, 2)) * [w, h]
    pos = rng.uniform(0, 1, (n, 2)) * ([w, h] - size)
    vel = rng.uniform(-12, 12, (n, 2))
    tex = [rng.integers(100, 255, (int(sh), int(sw), 3), np.uint8)
           for sw, sh in size]
    imgs, infos = [], []
    for f in range(t):
        img = bg.copy()
        ids = [i for i in range(n) if (i != 0 or f < (t + 1) // 2)
               and (i != n - 1 or f >= t // 2)]
        boxes = []
        for i in ids:
            x, y = pos[i].astype(int)
            th, tw = tex[i].shape[:2]
            img[y:y + th, x:x + tw] = tex[i]
            boxes.append([(x + tw / 2) / w, (y + th / 2) / h, tw / w, th / h])
        boxes = np.asarray(boxes, np.float32)
        imgs.append(((img / np.float32(255) - IMAGENET_MEAN) / IMAGENET_STD)
                    .astype(np.float32))
        infos.append({"boxes": boxes, "ids": np.asarray(ids),
                      "labels": np.zeros(len(ids), np.int64),
                      "areas": boxes[:, 2] * boxes[:, 3] * w * h})
        pos = np.clip(pos + vel, 0, [w, h] - size)
        vel[(pos <= 0) | (pos >= [w, h] - size)] *= -1
    return {"imgs": imgs, "infos": infos}


def train_batch(t: int, seed: int):
    from memotr_tpu_torch.data.loader import collate_clips
    batch = collate_clips([synthetic_clip(t, seed)],
                          TRAIN_CONFIG["MAX_GTS"])
    assert batch["images"].shape[2:4] == TRAIN_CANVAS, batch["images"].shape
    return batch


def phase_train(device, tag="12 train", config=TRAIN_CONFIG,
                steps=TRAIN_STEPS, per_frame=None, unreached=()):
    """Trains the bf16 ``config`` model through the Trainer (``steps``:
    the clip length of each step) and checks each kernel's launches per
    frame (``per_frame``; default: the deformable model's) and that the
    loss reaches every trainable parameter but those named in
    ``unreached`` (their gradient is zero, as JAX's is); returns (the
    trainer, counts of the run, each step's counts)."""
    from memotr_tpu_torch.engine.trainer import Trainer
    from memotr_tpu_torch.models.memotr import build_model
    from memotr_tpu_torch.ops import hungarian
    if per_frame is None:
        enc_dec = config["NUM_ENC_LAYERS"] + config["NUM_DEC_LAYERS"]
        per_frame = {"msda_fwd": enc_dec, "msda_bwd": enc_dec,
                     "window_attn_fwd": 0, "window_attn_bwd": 0}
    model = random_weights_(build_model(config))
    trainer = Trainer(model, config, device, seed=0)
    batches = [train_batch(t, seed=10 + i) for i, t in enumerate(steps)]
    totals = dict.fromkeys(per_frame, 0)
    per_step, peaks, prev_t = [], {}, None
    for i, (t, batch) in enumerate(zip(steps, batches)):
        if t != prev_t:
            torch.cuda.reset_peak_memory_stats(device)
            prev_t = t
        copies = hungarian.host_copies
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        logs = trainer.step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        copies = hungarian.host_copies - copies
        for k in totals:
            totals[k] += counts[k]
        per_step.append(counts)
        peaks[t] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        for k, v in logs.items():
            assert np.isfinite(float(v)), (i, k, v)
        assert logs["params_without_grad"] == len(unreached), \
            logs["params_without_grad"]
        for name, p in model.named_parameters():
            assert (p.grad is None) == (not p.requires_grad), name
            assert name not in unreached or not p.grad.any(), name
        for kernel, n in per_frame.items():
            assert counts[kernel] == n * t, \
                f"{kernel} launches {counts[kernel]}, expected {n} x {t}"
        assert copies == t, copies
        say(tag, f"step {i + 1} T={t}: {ms:.1f} ms (host wall, "
            f"synchronized; upload included), total_loss "
            f"{float(logs['total_loss']):.5f}, grad_norm "
            f"{float(logs['grad_norm']):.4f}, n_gts {int(logs['n_gts'])}; "
            + ", ".join(f"{k} {counts[k]} = {n} x {t}"
                        for k, n in per_frame.items())
            + f" launches ok; host matching copies {copies} (one per frame)")
    n_frozen = sum(not p.requires_grad for p in model.parameters())
    say(tag, f"every trainable parameter got a gradient in every step"
        + (f" ({', '.join(unreached)}: zero, unread by this model)"
           if unreached else "")
        + f", the {n_frozen} frozen ones (stem, layer1) none; peak device memory "
        f"(max_memory_allocated) " + ", ".join(
            f"T={t} {gib:.2f} GiB" for t, gib in sorted(peaks.items())))
    return trainer, totals, per_step


def profile_train_step(trainer, device, tag="12 train",
                       family="K1 msda_bwd"):
    """One more T=2 step, timed with the host matching timed apart, then
    the same under torch.profiler: device busy time by kernel family."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from memotr_tpu_torch.models import criterion
    batch = train_batch(2, seed=30)
    orig = criterion.hungarian_cost_padded
    spent = []

    def timed_match(cost, rows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(cost, rows)
        spent.append(time.perf_counter() - t0)
        return out

    criterion.hungarian_cost_padded = timed_match
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        criterion.hungarian_cost_padded = orig
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.step(batch)
        torch.cuda.synchronize()
    fam = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            k = kernel_family(e.key)
            fam[k] = fam.get(k, 0.0) + e.self_device_time_total / 1e3
    busy = sum(fam.values())
    say(tag, f"profile, one T=2 step: host wall {wall:.1f} ms "
        f"(of which host matching {1e3 * sum(spent):.1f} ms over "
        f"{len(spent)} copies: device-to-host copy, scipy, upload), device "
        f"busy {busy:.1f} ms (profiler, the next step), idle share "
        f"{1 - busy / wall:.3f}")
    for k, v in sorted(fam.items(), key=lambda kv: -kv[1]):
        say(tag, f"  {k}: {v:.2f} ms ({v / busy:.1%} of busy)")
    assert fam.get(family, 0) > 0, f"no {family} time in the trace"


def phase_train_f32(model_bf16, device, tag="13 train f32",
                    config=TRAIN_CONFIG, norm_rtol=TRAIN_NORM_RTOL):
    """One float32 T=1 step's loss and gradient norms through the kernels
    and through the plain MSDA and window attention (the phase-6 / 8
    swap), from ``model_bf16``'s weights."""
    import copy

    from memotr_tpu_torch.engine.trainer import Trainer, param_groups
    from memotr_tpu_torch.models import msda_module, windowed_encoder
    from memotr_tpu_torch.models.memotr import build_model
    from memotr_tpu_torch.ops.msda import ms_deform_attn_torch
    from memotr_tpu_torch.ops.window_attn import window_attention_torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(config, DTYPE="float32")
    model = build_model(cfg)
    model.load_state_dict(model_bf16.state_dict())
    batch = train_batch(1, seed=40)
    kernels = (msda_module.ms_deform_attn, windowed_encoder.window_attention)
    res = {}
    for route in ("kernels", "plain"):
        m = copy.deepcopy(model)
        tr = Trainer(m, cfg, device, seed=0)
        if route == "plain":
            msda_module.ms_deform_attn = ms_deform_attn_torch
            windowed_encoder.window_attention = window_attention_torch
        try:
            logs = tr.grad_step(tr.batch_to_device(batch), tr.generator)
        finally:
            msda_module.ms_deform_attn, windowed_encoder.window_attention = \
                kernels
        norms = {}
        for g, ps in param_groups(m).items():
            sq = [(p.grad.double() ** 2).sum() for p in ps
                  if p.grad is not None]
            norms[g] = float(torch.stack(sq).sum().sqrt()) if sq else 0.0
        norms["global"] = float(np.sqrt(sum(v ** 2 for v in norms.values())))
        res[route] = (float(logs["total_loss"]), norms)
        del tr, m
    (lk, nk), (lp, npl) = res["kernels"], res["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    say(tag, f"TF32 off; T=1 total_loss kernels {lk:.7f} plain {lp:.7f} "
        f"(rel {loss_rel:.2e}, tolerance {TRAIN_LOSS_RTOL})")
    rels = {g: abs(nk[g] - npl[g]) / max(abs(npl[g]), 1e-30) for g in nk}
    for g, rel in rels.items():
        say(tag, f"grad norm {g}: kernels {nk[g]:.6e} plain {npl[g]:.6e} "
            f"(rel {rel:.2e}, tolerance {norm_rtol})")
    assert np.isfinite(lk) and loss_rel <= TRAIN_LOSS_RTOL, (lk, lp)
    for g, rel in rels.items():
        assert rel <= norm_rtol or nk[g] == npl[g], (g, nk[g], npl[g])
    say(tag, f"loss and every group's norm within tolerance ok; largest "
        f"norm change {max(rels.values()):.2e}")


# --------------------------------------------------------- batched serving
class SyntheticSequence:
    """``n`` synthetic frames behind the interface of ``SeqDataset`` that
    ``stream_sequences`` reads: length, indexing and ``padded_canvas``."""

    def __init__(self, n: int, seed: int):
        self.frames = list(synthetic_frames(n, seed))

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return self.frames[i]

    def padded_canvas(self):
        return CANVAS


def mot_rows(path):
    """MOT txt -> [(frame, id, x, y, w, h)]."""
    with open(path) as f:
        return [tuple(int(v) if i < 2 else float(v) for i, v in
                      enumerate(line.split(",")[:6]))
                for line in f.read().splitlines()]


def check_counts(tag, counts, per_step, steps):
    for kernel, n in per_step.items():
        assert counts[kernel] == n * steps, \
            f"{tag}: {kernel} launches {counts[kernel]}, expected {n} x {steps}"
    return ", ".join(f"{k} {counts[k]} = {n} x {steps}"
                     for k, n in per_step.items())


def phase_batched(device, config, per_step, tag):
    """SUBMIT_BATCH 2 through ``stream_sequences`` (what ``submit()`` runs
    after loading): two lanes of unequal length in one BatchedSubmitter.
    At float32 (TF32 off, ``scaled_weights_``, thresholds BATCH_THRESH)
    against SUBMIT_BATCH 1 on the same sequences: each lane's frames and
    ids equal, boxes within FRAME_ATOL of the frame's size, launch counts
    per step (``per_step``).  Then bf16 frames/s at B=1 (the
    Submitter) and B=2 (the BatchedSubmitter), steady state.  Returns the
    launch counts of the bf16 B=2 run and the largest box difference."""
    from memotr_tpu_torch.engine.submit import (BatchedSubmitter, Submitter,
                                                stream_sequences)
    from memotr_tpu_torch.models.memotr import build_model
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dict(config, DTYPE="float32", DET_SCORE_THRESH=BATCH_THRESH,
                 TRACK_SCORE_THRESH=BATCH_THRESH,
                 RESULT_SCORE_THRESH=BATCH_THRESH)
    model = scaled_weights_(build_model(cfg32)).to(device).eval()
    seqs = [(f"lane{i}", SyntheticSequence(n, seed=3 + i))
            for i, n in enumerate(BATCH_LANES)]
    rows = {}
    for batch in (1, 2):
        with tempfile.TemporaryDirectory() as out:
            torch.cuda.synchronize()
            reset_counts()
            stream_sequences("DanceTrack", seqs, out, model,
                             dict(cfg32, SUBMIT_BATCH=batch), device)
            torch.cuda.synchronize()
            counts = read_counts()
            rows[batch] = {name: mot_rows(os.path.join(
                out, "tracker", f"{name}.txt")) for name, _ in seqs}
        steps = sum(BATCH_LANES) if batch == 1 else max(BATCH_LANES)
        say(tag, f"float32 (TF32 off) SUBMIT_BATCH {batch}: launches "
            f"{check_counts(tag, counts, per_step, steps)} steps ok")
    worst, tol = 0.0, FRAME_ATOL["pred_boxes"]
    size = np.asarray(ORI_HW[::-1] * 2, np.float64)      # x, y, w, h
    for (name, _), n in zip(seqs, BATCH_LANES):
        ref, got = rows[1][name], rows[2][name]
        assert ref, f"{name}: empty MOT txt"
        keys = [r[:2] for r in ref], [g[:2] for g in got]
        assert keys[1] == keys[0], (
            f"{name}: frames or ids differ from the B=1 run: "
            f"{len(keys[0])} vs {len(keys[1])} lines, first difference "
            + str(next((a, b) for a, b in zip(*keys) if a != b)
                  if any(a != b for a, b in zip(*keys)) else "in length"))
        assert max(r[0] for r in got) <= n, name
        diff = max(np.abs(np.subtract(r[2:], g[2:]) / size).max()
                   for r, g in zip(ref, got))
        assert diff <= tol, (name, diff)
        worst = max(worst, diff)
        say(tag, f"float32 {name} ({n} frames): {len(got)} MOT lines, "
            f"frames and ids equal to the B=1 run, boxes within {diff:.3e} "
            f"of the frame's size (<= {tol}) ok")

    model = random_weights_(build_model(config)).to(device).eval()
    lanes = [SyntheticSequence(N_FPS_FRAMES, seed=5 + i) for i in range(2)]
    fps = {}
    with tempfile.TemporaryDirectory() as out:
        for batch in (1, 2):
            if batch == 1:
                sub = Submitter("DanceTrack", iter(lanes[0].frames), "lane0",
                                out, model, config, device)
            else:
                sub = BatchedSubmitter("DanceTrack", lanes, ["lane0", "lane1"],
                                       out, model, config, device)
            torch.cuda.synchronize()
            reset_counts()
            sub.run()
            torch.cuda.synchronize()
            counts = read_counts()
            launches = check_counts(tag, counts, per_step, N_FPS_FRAMES)
            ms = steady_ms(sub.frame_seconds)
            fps[batch] = batch * 1e3 / ms.mean()
            say(tag, f"bf16 B={batch}: {fps[batch]:.2f} frames/s over steps "
                f"3-{N_FPS_FRAMES} (ms/step mean {ms.mean():.2f}, median "
                f"{np.median(ms):.2f}); launches {launches} steps ok")
    say(tag, f"bf16 frames/s B=2 / B=1 = {fps[2] / fps[1]:.3f}")
    return counts, worst


def phase_motion(device, tag="19 motion"):
    """USE_MOTION through the Submitter's sync loop (a few bf16 frames of
    the deformable model): the loop taken, the launches, the records."""
    from memotr_tpu_torch.models.memotr import build_model
    cfg = dict(CONFIG, USE_MOTION=True)
    model = random_weights_(build_model(cfg)).to(device).eval()
    sub, counts, txt, wall = stream(tag, model, cfg,
                                    synthetic_frames(N_MOTION_FRAMES, seed=6),
                                    device, loop="sync")
    per_frame = CONFIG["NUM_ENC_LAYERS"] + CONFIG["NUM_DEC_LAYERS"]
    assert counts["msda_fwd"] == per_frame * N_MOTION_FRAMES, counts
    assert len(sub.live) == N_MOTION_FRAMES
    long = sum(len(m) >= m.min_record_length
               for m in sub.motion_bank.records.values())
    say(tag, f"sync loop, {N_MOTION_FRAMES} frames in {1e3 * wall:.1f} ms: "
        f"msda_fwd launches {counts['msda_fwd']} = {per_frame} x "
        f"{N_MOTION_FRAMES} ok; {len(sub.motion_bank.records)} tracks "
        f"recorded, {long} with a record long enough to extrapolate; MOT "
        f"lines {len(txt.splitlines())}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke run needs "
                         "an NVIDIA GPU")
    from memotr_tpu_torch.models.memotr import build_model
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

    phase_build()

    t0 = time.perf_counter()
    k1_err, k1_times = phase_k1(device)
    say("3 K1", f"done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k2_err, k2_times = phase_k2(device)
    say("4 K2", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    model, _ = phase_slice("5 deformable", CONFIG, N_FRAMES,
                           {"msda_fwd": CONFIG["NUM_ENC_LAYERS"]
                            + CONFIG["NUM_DEC_LAYERS"], "window_attn_fwd": 0},
                           device)
    phase_frame_f32("6 deformable f32", CONFIG, model, device, FRAME_ATOL)
    del model
    say("6 deformable f32", f"phases 5-6 done in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    n_levels = WINDOWED_CONFIG["NUM_FEATURE_LEVELS"]
    model, counts = phase_slice(
        "7 windowed", WINDOWED_CONFIG, N_FRAMES,
        {"window_attn_fwd": WINDOWED_CONFIG["NUM_ENC_LAYERS"] * n_levels,
         "msda_fwd": WINDOWED_CONFIG["NUM_DEC_LAYERS"]}, device, live="any")
    phase_frame_f32("8 windowed f32", WINDOWED_CONFIG, model, device,
                    WINDOWED_FRAME_ATOL)
    phase_profile(model, WINDOWED_CONFIG, device)
    del model
    say("9 profile", f"phases 7-9 done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    model, hybrid_counts = phase_slice(
        "10 hybrid", HYBRID_CONFIG, N_HYBRID_FRAMES,
        {"window_attn_fwd": HYBRID_CONFIG["NUM_ENC_LAYERS"],
         "msda_fwd": HYBRID_CONFIG["NUM_ENC_LAYERS"]
         + HYBRID_CONFIG["NUM_DEC_LAYERS"]}, device, live=None)
    del model
    say("10 hybrid", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    dec_layers = CONFIG["NUM_DEC_LAYERS"]
    batched_counts, batch_box = phase_batched(
        device, CONFIG, {"msda_fwd": CONFIG["NUM_ENC_LAYERS"] + dec_layers,
                         "window_attn_fwd": 0}, "18 batched deformable")
    win_batched_counts, win_batch_box = phase_batched(
        device, WINDOWED_CONFIG,
        {"window_attn_fwd": WINDOWED_CONFIG["NUM_ENC_LAYERS"] * n_levels,
         "msda_fwd": dec_layers}, "18 batched windowed")
    say("18 batched", f"done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_motion(device)
    say("19 motion", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    k1b_err, k1b_times = phase_k1_bwd(device)
    say("11 K1 bwd", f"done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trainer, train_counts, train_steps = phase_train(device)
    profile_train_step(trainer, device)
    say("12 train", f"done in {time.perf_counter() - t0:.1f} s")
    del trainer
    t0 = time.perf_counter()
    phase_train_f32(scaled_weights_(build_model(TRAIN_CONFIG)), device)
    say("13 train f32", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    k2b_err, k2b_times = phase_k2_bwd(device)
    say("14 K2 bwd", f"done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    win_layers = WINDOWED_TRAIN_CONFIG["NUM_ENC_LAYERS"] * n_levels
    win_dec = WINDOWED_TRAIN_CONFIG["NUM_DEC_LAYERS"]
    trainer, win_counts, win_steps = phase_train(
        device, "15 windowed train", WINDOWED_TRAIN_CONFIG, TRAIN_STEPS,
        {"window_attn_fwd": win_layers, "window_attn_bwd": win_layers,
         "msda_fwd": win_dec, "msda_bwd": win_dec})
    profile_train_step(trainer, device, "15 windowed train",
                       "K2 window_attn_bwd")
    del trainer
    say("15 windowed train", f"done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hyb_layers = HYBRID_TRAIN_CONFIG["NUM_ENC_LAYERS"]
    hyb_msda = hyb_layers + HYBRID_TRAIN_CONFIG["NUM_DEC_LAYERS"]
    trainer, _, hyb_steps = phase_train(
        device, "16 hybrid train", HYBRID_TRAIN_CONFIG, HYBRID_TRAIN_STEPS,
        {"window_attn_fwd": hyb_layers, "window_attn_bwd": hyb_layers,
         "msda_fwd": hyb_msda, "msda_bwd": hyb_msda})
    del trainer
    say("16 hybrid train", f"done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_train_f32(scaled_weights_(build_model(WINDOWED_TRAIN_CONFIG)),
                    device, "17 windowed train f32", WINDOWED_TRAIN_CONFIG,
                    WINDOWED_TRAIN_NORM_RTOL)
    say("17 windowed train f32", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    model, conv_counts = phase_slice(
        "20 conv", CONV_CONFIG, N_CONV_FRAMES,
        {"msda_fwd": CONV_CONFIG["NUM_DEC_LAYERS"], "window_attn_fwd": 0},
        device, live=None)
    del model
    conv_dec = CONV_TRAIN_CONFIG["NUM_DEC_LAYERS"]
    # the conv encoder reads no position embedding, so the level embedding
    # added to them gets no gradient
    trainer, conv_train_counts, _ = phase_train(
        device, "20 conv train", CONV_TRAIN_CONFIG, (2,),
        {"msda_fwd": conv_dec, "msda_bwd": conv_dec, "window_attn_fwd": 0,
         "window_attn_bwd": 0}, unreached=("transformer.level_embed",))
    del trainer
    say("20 conv", f"done in {time.perf_counter() - t0:.1f} s")
    say("all", f"{time.perf_counter() - t_all:.1f} s")

    k1, k2 = k1_times["encoder"], k2_times["window_l0"]
    k1b, k2b = k1b_times["encoder"], k2b_times["window_l0"]
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": "msda_fwd", "route": "cuda", "source": K1_SRC,
         "replaces": K1_TPU, "launches": counts["msda_fwd"],
         "max_abs_err": k1_err, "ms": k1["ms"], "device_ms": k1["device_ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None,
         "library_device_ms": None, "shape": "encoder B=1 Lq=25512 bf16",
         "launches_hybrid": hybrid_counts["msda_fwd"],
         "launches_batched": batched_counts["msda_fwd"],
         "launches_conv": conv_counts["msda_fwd"],
         "launches_train_conv": conv_train_counts["msda_fwd"],
         "encoder_b2": {k: k1_times["encoder_b2"][k] for k in (
             "ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
             "bound_by")}},
        {"name": "window_attn_fwd", "route": "cuda", "source": K2_SRC,
         "replaces": K2_TPU, "launches": counts["window_attn_fwd"],
         "max_abs_err": k2_err, "ms": k2["ms"], "device_ms": k2["device_ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": k2["library_ms"],
         "library_device_ms": k2["library_device_ms"],
         "library": "composition: matmuls + scaled_dot_product_attention",
         "shape": "window level 0 104x192 L=64 bf16",
         "launches_hybrid": hybrid_counts["window_attn_fwd"],
         "launches_train_windowed": win_counts["window_attn_fwd"],
         "launches_batched": win_batched_counts["window_attn_fwd"],
         **{case: {k: k2_times[case][k] for k in (
             "ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
             "library_device_ms", "bound_ms", "bound_by")}
            for case in ("window_l0_b2", "grid_l0_b2")}},
        {"name": "msda_bwd", "route": "cuda", "source": K1B_SRC,
         "replaces": K1B_TPU, "launches": train_counts["msda_bwd"],
         "launches_per_step": [c["msda_bwd"] for c in train_steps],
         "max_abs_err": k1b_err,
         "ms": k1b["ms"], "device_ms": k1b["device_ms"],
         "kernel_device_ms": k1b["kernel_device_ms"],
         "plain_ms": k1b["plain_ms"],
         "plain_device_ms": k1b["plain_device_ms"],
         "bound_ms": k1b["bound_ms"], "bound_by": k1b["bound_by"],
         "library_ms": None, "library_device_ms": None,
         "shape": "encoder B=1 Lq=28560 bf16 (896x1536)",
         "launches_train_fwd": train_counts["msda_fwd"],
         "launches_train_windowed": win_counts["msda_bwd"]},
        {"name": "window_attn_bwd", "route": "cuda", "source": K2B_SRC,
         "replaces": K2B_TPU, "launches": win_counts["window_attn_bwd"],
         "launches_per_step": {
             "windowed": [c["window_attn_bwd"] for c in win_steps],
             "hybrid": [c["window_attn_bwd"] for c in hyb_steps]},
         "max_abs_err": k2b_err, "ms": k2b["ms"],
         "device_ms": k2b["device_ms"],
         "kernel_device_ms": k2b["kernel_device_ms"],
         "plain_ms": k2b["plain_ms"],
         "plain_device_ms": k2b["plain_device_ms"],
         "library_ms": k2b["library_ms"],
         "library_device_ms": k2b["library_device_ms"],
         "library": "autograd backward of the composition: matmuls + "
                    "scaled_dot_product_attention",
         "bound_ms": k2b["bound_ms"], "bound_by": k2b["bound_by"],
         "kernel_bound_ms": k2b["kernel_bound_ms"],
         "kernel_bound_by": k2b["kernel_bound_by"],
         "shape": "window level 0 112x192 L=64 bf16 (896x1536)",
         "grid_level0": {k: k2b_times["grid_l0"][k] for k in (
             "device_ms", "kernel_device_ms", "plain_device_ms",
             "library_device_ms", "bound_ms", "kernel_bound_ms")}}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
