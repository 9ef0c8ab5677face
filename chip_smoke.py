"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed on its own line; any failure ends the run with a
nonzero exit and no result line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: the five kernel libraries from memotr_tpu_torch/csrc/ (K1 and
   its backward, K2 and its backward, the backbone's conv_tail; one nvcc
   each, in parallel), with ptxas's registers and spills per kernel;
3. K1 (MSDA forward), through the wrapper the main path calls without a
   gradient (``ops.msda.ms_deform_attn``: the ``msda_fwd`` torch op), vs
   plain PyTorch on the card at the MSDA shapes of the paths (encoder B=1 and B=2, decoder B=1 and B=2, one awkward shape),
   float32 and
   bfloat16, with out-of-bounds taps; per call, over 20 calls, the device
   time (the call's CUDA kernels, torch.profiler) and the event-timed call
   (which includes the op's and the wrapper's host work), and the
   achieved rate of
   gathered corner bytes;
4. K2 (fused window attention), through ``ops.window_attn.window_attention``
   (the ``window_attn_fwd`` op), vs plain PyTorch at the main path's shapes
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
    the call, of each of its CUDA kernels pass by pass and of the plain
    backward, the bound, its route (cell buckets) and its atomics (one
    int32 atomicAdd a filed sample, no float atomic);
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
    of the hand-written kernels (projections, attention core, bias
    reduction: each pass), of the whole backward call (kernels and its
    matmuls), of the plain version's autograd and of the library
    composition's autograd backward, both bounds, the route taken
    (tensor_cores or tensor_cores_tiled) and its atomics (none);
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
21. one float32 hybrid training step (T=1, TF32 off) through the kernels
    and through the plain K1 and K2, on ``scaled_weights_``, as phase 17
    (the norms to WINDOWED_TRAIN_NORM_RTOL; five H100 runs read 5.6e-5);
22. the training entry (``memotr_tpu_torch.main``, as a user runs it) on a
    synthetic DanceTrack tree of 1920x1080 JPEGs (2 train videos of 6
    frames, 1 val video of 6) with a reference-format .pth of
    ``random_weights_`` as PRETRAINED_MODEL: configs/train_dancetrack.yaml
    (full width, bfloat16, NUM_WORKERS 4, the MOTR_SCALES transforms) with
    SAMPLE_STEPS [1, 10, 14], 2 epochs (10 steps at T=2, 8 at T=3), 12 T K1
    forward and backward launches every step; finite losses in
    scalars.jsonl, both epoch checkpoints, trainable parameters moved and
    frozen ones not; host ms per iteration, the loader's wait and its
    share, peak memory, a profiled iteration's idle share; then resume
    from checkpoint_0.pth twice (epoch 1 only: the same states, the first
    iteration's losses equal the unbroken run's, the AdamW state at its
    start checkpoint_0's bit for bit and after its first step the unbroken
    run's, exp_avg_sq sums within RESUME_V_RTOL, the step counts after the
    epoch equal, parameters within RESUME_STEP_BOUND x LR a step; the
    second resumed run against the first printed as the noise witness),
    ClipDataset.get
    timed clip by clip on one host thread (the Data layer), submit of the
    val split from checkpoint_1.pth at ENTRY_THRESH (its first frame's
    rows are the model's own forward's detections above it that take the
    TRACK_SLOTS slots, in query order, with an area over 100 px, and the
    best of those scores clears ENTRY_SCORE_FLOOR; the decode path
    named), and the
    windowed flagship (configs/train_dancetrack_windowed.yaml, one 5-frame
    video, 4 steps) through the same entry: 12 T K2 and 6 T K1 launches,
    forward and backward, every step;
23. evaluation on phase 22's run through ``memotr_tpu_torch.main --mode
    eval``: ``specific`` on checkpoint_1.pth, then ``continue`` over both
    epoch checkpoints, on the val split (1920x1080 JPEGs at short side
    800; 12 K1 launches a frame); the tracker directories,
    pedestrian_summary.txt, eval_states.yaml and finite HOTA, DetA, AssA,
    MOTA and IDF1; submit ms a frame, the metrics' host seconds a
    sequence; then the train
    split's two gt.txt scored as a tracker with ``num_parallel`` 8 (a
    spawned pool of 2 in this process, after CUDA and the loader's
    threads; a pool that has not finished in EVAL_POOL_TIMEOUT fails the
    phase) read HOTA = MOTA = IDF1 = 100, as in one process;
24. distillation: phase 22's windowed flagship (its tree, YAML and
    pretrained .pth) learns from phase 22's deformable checkpoint_1.pth
    through ``--distill-teacher``: 4 steps at T=2, 12 T more K1 forward
    launches a step than phase 22's windowed run and the same K1
    backward, K2 forward and K2 backward counts; the three distillation
    terms finite and > 0 every step; the teacher untouched, frozen, out
    of the optimizer and of the student's checkpoint; host ms an
    iteration against phase 22's windowed run, peak memory, and a
    profiled step's idle share and the teacher's share of its device
    time;
25. serving: ``memotr_tpu_torch.serving.export_streaming`` of the
    deformable and the windowed model (``random_weights_``, bf16, 800x1536)
    on the card (export seconds, the .pt2's size); a fresh process that
    imports only ``memotr_tpu_torch.serving`` (asserted: no model, engine
    or JAX module) loads each artifact, steps 8 synthetic frames and counts
    K1's and K2's launches a frame there (12 and 0 deformable, 6 and 12
    windowed); its rows equal the live ``eval_frame_step`` +
    ``pack_results`` on the same frames (ids, labels and alive exactly,
    boxes and scores to SERVING_ATOL), ``reset()`` replays frame 0 bit for
    bit; ms a frame of ``ServingRuntime.step`` against the live step's
    (frames 3-8) and the idle share of 3 profiled runtime frames; then
    ``python -m memotr_tpu_torch.tools.export_serving`` on phase 22's
    checkpoint_1.pth (one frame stepped), ``VISUALIZE`` on a 3-frame submit
    (the dump files and the JAX package's keys) and
    ``memotr_tpu_torch.tools.demo`` on a 5-frame synthetic XVID video (5
    annotated frames out, 12 K1 launches a frame);
26. the quality campaign's tool (``memotr_tpu_torch.tools.flagship_eval``)
    at its configs (HIDDEN_DIM 256, float32, 256x320): first K1 and K2 at
    the campaign's shapes (the 1,700-token pyramid, decoder Lq 64, K2's
    window and grid attention at every level), forward at B=8 (the
    evaluation's lanes) and backward at B=1, against the plain versions
    at the float32 tolerances of phases 3, 4, 11 and 14; then on a small
    proxy-v3 world (2 train sequences of 24 frames, 8 val sequences of 16)
    ``run_variant`` trains deformable_w256 one epoch, then
    windowed_w256_transplant and hybrid_w256_transplant from its last
    checkpoint (merge counts: every teacher tensor outside the encoder
    loaded, the encoder's skipped), each scored on 8 lanes; the launches
    of each kernel a run (set to 0 just before it) and a step; host ms an
    iteration at T=2 and T=3, the idle share of one profiled iteration,
    peak memory and the extrapolated wall of one full 10-epoch v3 run;
    then ``quality_report`` and ``scalars_report`` over the workdir;
27. ``USE_CHECKPOINT`` at 896x1536: a bf16 deformable T=5 step off and
    on from the same weights and batch (peak memory and host ms of each;
    K1 forward launches doubled, 2 x 12 x T, by the recompute, backward
    unchanged), a bf16 windowed T=2 step off and on (K2 and the decoder's
    K1 forward doubled, backward unchanged), and a float32 T=1 step on
    ``scaled_weights_`` off and on: gradients within TRAIN_NORM_RTOL;
28. ``EXTRA_TRACK_ATTN`` and ``DROPOUT`` 0.1: a float32 deformable T=2
    step (finite losses, a live gradient in every ``track_attn`` and
    ``norm4``), the same step with ``USE_CHECKPOINT`` from the same seed
    (gradients within TRAIN_NORM_RTOL: the recompute draws the forward's
    masks); a bf16 windowed T=2 step at DROPOUT 0.1 takes the composed
    route (0 K2 launches), and the same model streams 2 frames through
    K2 (12 a frame);
29. several processes: ``torchrun --standalone --nproc_per_node 1`` of
    ``memotr_tpu_torch.main --multi-host --mode train`` for one epoch of
    phase 22's train tree (the NCCL group, 12 x T K1 launches a step,
    rank 0's checkpoint); then two ranks on the one card over gloo with
    CUDA tensors, one float32 T=2 clip each: parameters equal on both
    ranks bit for bit and within TRAIN_NORM_RTOL (norms) of one process's
    step on both clips, MetricLog.sync's totals, and a two-sequence
    submit, one sequence a rank, whose union equals one process's txt;
30. conv_tail (the backbone's bias + identity + ReLU after each folded
    convolution), through the ``conv_tail`` op, vs plain PyTorch at two
    tail shapes of the main path (layer1 and layer3 conv3, B=8 at
    800x1536, bfloat16, with identity): equal bit for bit; device time
    against the bytes bound.  Phases 5, 7, 10 and 20 also count its
    launches, 49 a frame (the stem and three a bottleneck), and the
    backbone's one fold of its weights.
Phases run in the order 1-4, 30, 5-10, 18, 19, 11-17, 20, 21, 22, 23, 24,
25, 26-29; then a JSON line of the training entry's numbers, a JSON line of
evaluation's and distillation's, a JSON line of serving's, a JSON line of
the campaign's, a JSON line of phases 27-29, the card's name and power
limit, a JSON line of kernel results and, last, the device line
``{"ok": true, "device": {...}}``.

There is no CPU path: without a CUDA device the script exits nonzero.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
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
# cell sums take their entries in a run-dependent order), grad_value in
# bf16 also rtol 8e-3 (one rounding of its float32 sum to bf16)
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
# channels in another order.  bfloat16: the kernel path rounds Q, K, V, dO, the
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
                         "window_attn_bwd", "conv_tail")
    say("2 build", f"msda_fwd, msda_bwd, window_attn_fwd, window_attn_bwd "
        f"and conv_tail (nvcc, sm_90a, in parallel) in "
        f"{time.perf_counter() - t0:.1f} s")
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
    """K1 through the wrapper the main path calls without a gradient
    (``ops.msda.ms_deform_attn``: the ``msda_fwd`` op) vs the plain version
    on the card; returns (max f32 error, times)."""
    from memotr_tpu_torch.ops import msda_cuda
    from memotr_tpu_torch.ops.msda import ms_deform_attn
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
                before = msda_cuda.launches
                out = ms_deform_attn(v, shapes, loc, aw)
                assert msda_cuda.launches == before + 1, "no K1 launch"
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
                k_ms, k_dev, _ = timed(lambda: ms_deform_attn(
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


# ------------------------------------------------------------ conv tail
# the backbone's tails a frame on the bf16 inference route: the stem and
# three a bottleneck (models/resnet.py: ResNet50.forward_folded)
BACKBONE_TAILS = 49
# (N, C, H, W) of two tails with identity on the main path (B=8, 800x1536)
CONV_TAIL_SHAPES = {"layer1_conv3": (8, 256, 200, 384),
                    "layer3_conv3": (8, 1024, 50, 96)}


def phase_conv_tail(device):
    """The ``conv_tail`` op's kernel against the plain version on the card
    at two of the backbone's tail shapes (bf16, channels_last, identity and
    ReLU): equal bit for bit (the same float32 sums, one rounding), one
    launch a call; then each one's device time against the bytes bound
    (y and identity read, y written)."""
    from memotr_tpu_torch.ops import conv_tail as ct
    from memotr_tpu_torch.ops.library import conv_tail
    g = torch.Generator(device=device).manual_seed(0)
    with torch.inference_mode():
        for name, (n, c, h, w) in CONV_TAIL_SHAPES.items():
            y, identity = (torch.randn((n, c, h, w), generator=g,
                                       device=device).to(
                torch.bfloat16, memory_format=torch.channels_last)
                for _ in range(2))
            bias = torch.randn(c, generator=g, device=device)
            want = ct.conv_tail_torch(y, bias, identity, True)
            got = y.clone()
            before = ct.launches
            conv_tail(got, bias, identity, True)
            assert ct.launches == before + 1, "no conv_tail launch"
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, (got.float() - want.float()
                                                   ).abs().max().item())
            del got, want
            nbytes = 3 * y.numel() * y.element_size() + c * 4
            b_ms, b_by = bound(nbytes, 0, torch.bfloat16)
            k_ms, k_dev, _ = timed(lambda: conv_tail(y, bias, identity, True))
            p_ms, p_dev, _ = timed(lambda: ct.conv_tail_torch(
                y, bias, identity, True))
            say("30 conv_tail", f"{name} {n}x{c}x{h}x{w} bf16 with identity: "
                f"equal to the plain version ok; kernel device {k_dev:.4f} ms "
                f"(event-timed call {k_ms:.4f} ms), plain device {p_dev:.4f} "
                f"ms (call {p_ms:.4f} ms), bound {b_ms:.4f} ms ({b_by}, "
                f"{nbytes / 1e6:.1f} MB): {100 * b_ms / k_dev:.1f}% of it, "
                f"{nbytes / k_dev / 1e6:.1f} GB/s")


# ------------------------------------------------------------------- K2
def canvas_mask(device, canvas=CANVAS, valid=RESIZED) -> torch.Tensor:
    """(1, H, W) padding mask of the synthetic frames: the streaming
    800x1536 canvas (768x1536 valid), or the training canvas."""
    mask = torch.ones((1,) + canvas, dtype=torch.bool, device=device)
    mask[:, :valid[0], :valid[1]] = False
    return mask


# K2's named cases: (pyramid level, grid attention, batch); "_b2" are the
# batched serving lanes' shapes (SUBMIT_BATCH 2, one canvas); k2_case's
# ``batch`` sets another batch
K2_CASES = {"window_l0": (0, False, 1), "window_l1": (1, False, 1),
            "window_l2": (2, False, 1), "window_l3": (3, False, 1),
            "grid_l0": (0, True, 1),
            "grid_l1": (1, True, 1), "grid_l2": (2, True, 1),
            "grid_l3": (3, True, 1), "window_l0_b2": (0, False, 2),
            "grid_l0_b2": (0, True, 2), "window_l0_b24": (0, False, 24),
            "grid_l0_b24": (0, True, 24)}
# The previous kernel's device ms a call at the cell's B=24 shapes (two
# mma.sync launches, a block a head; the mean of six readings in three calls
# of PERF.md section 6, NVIDIA H100 80GB HBM3 at 700 W), printed beside the
# wgmma route's.
K2_PARENT_MS = {"window_l0_b24": 3.02, "grid_l0_b24": 5.21}


def k2_case(name, dtype, device, seed=0, train=False, geometry=None,
            batch=None):
    """(args, (heads, window_h, window_w)) of a window_attention call: the
    main path's level maps (C=256, 8 heads, window 8) of the 800x1536
    streaming canvas, or with ``train`` of the 896x1536 training canvas,
    or of ``geometry`` (level shapes, canvas, valid), padded to window
    multiples with the canvas's mask, at batch 1 or 2 (``K2_CASES``) or
    ``batch``, or an awkward one."""
    from memotr_tpu_torch.models.memotr import _downsample_mask
    from memotr_tpu_torch.ops.window_attn import grid_transpose
    rng = np.random.default_rng(seed)
    shapes, canvas = ((TRAIN_ENC_SHAPES, (TRAIN_CANVAS, TRAIN_VALID)) if train
                      else (ENC_SHAPES, (CANVAS, RESIZED)))
    if geometry is not None:
        shapes, canvas = geometry[0], geometry[1:]
    if name == "awkward":
        b, heads, win = 2, 4, 4
        mask = torch.zeros((b, 16, 24), dtype=torch.bool, device=device)
        mask[:, :, 21:] = True
        mask[1, :win, :win] = True             # a fully padded window
        grid, with_bias = False, False
    else:
        heads, win = 8, 8
        lvl, grid, b = K2_CASES[name]
        b = batch or b
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
    """K2 through the wrapper the main path calls without a gradient
    (``ops.window_attn.window_attention``: the ``window_attn_fwd`` op) vs
    the plain version on the card; bf16 at C=256 must take the wgmma route.
    Timed at level 0 of the 800x1536 canvas at B=1, 2 and 24 (the
    ``windowed_stream_b24`` cell's lanes); returns (max f32 error,
    times)."""
    from memotr_tpu_torch.ops import window_attn_cuda
    from memotr_tpu_torch.ops.window_attn import (window_attention,
                                                  window_attention_torch)
    worst = 0.0
    times = {}
    with torch.inference_mode():
        for name in ("window_l0", "grid_l0", "grid_l3", "window_l0_b2",
                     "grid_l0_b2", "window_l0_b24", "grid_l0_b24",
                     "awkward"):
            # the cell's B=24 shapes in bf16 only (float32 takes the
            # CUDA-core kernels, held at B=1 and 2)
            dtypes = (torch.bfloat16,) if name.endswith("b24") else \
                (torch.float32, torch.bfloat16)
            for dtype in dtypes:
                args, geo = k2_case(name, dtype, device)
                before = window_attn_cuda.launches
                out = window_attention(*args, *geo)
                assert window_attn_cuda.launches == before + 1, \
                    "no K2 launch"
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
                del out, ref, args
            if name == "awkward":
                continue
            args, geo = k2_case(name, torch.bfloat16, device, seed=1)
            tc_before = window_attn_cuda.routes["wgmma"]
            lib = library_window_attention(*args, *geo)
            ref = window_attention_torch(args[0].float(), args[1].float(),
                                         *args[2:], *geo)
            lib_err = (lib.float() - ref).abs().max().item()
            del lib, ref
            assert lib_err <= K2_BF16_ATOL, ("library", name, lib_err)
            runs = 5 if name.endswith("b24") else 20
            k_ms, k_dev, parts = timed(
                lambda: window_attention(*args, *geo), runs)
            assert window_attn_cuda.routes["wgmma"] > tc_before, \
                f"{name}: bf16 at C=256, head dim 32 did not take the wgmma route"
            p_ms, p_dev, _ = timed(
                lambda: window_attention_torch(*args, *geo), runs)
            l_ms, l_dev, _ = timed(
                lambda: library_window_attention(*args, *geo), runs)
            b_ms, b_by = k2_bound(args, geo)
            flops = k2_flops(args, geo)
            times[name] = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                               plain_device_ms=p_dev, library_ms=l_ms,
                               library_device_ms=l_dev, bound_ms=b_ms,
                               bound_by=b_by)
            parent = K2_PARENT_MS.get(name)
            say("4 K2", f"{name} bf16, per call over {runs}: kernel device "
                f"{k_dev:.4f} ms (event-timed call {k_ms:.4f} ms), previous "
                f"kernel device "
                + (f"{parent:.4f} ms" if parent else "not measured")
                + f", plain device {p_dev:.4f} ms (call {p_ms:.4f}), library "
                f"composition device {l_dev:.4f} ms (call {l_ms:.4f}; its "
                f"max_abs_err {lib_err:.3e}), bound {b_ms:.4f} ms ({b_by}); "
                f"achieved {flops / k_dev / 1e9:.1f} TFLOP/s (device time), "
                f"{b_ms / k_dev:.1%} of the bound")
            say("4 K2", f"{name} bf16 device time by CUDA kernel (profiler, "
                f"{runs} calls): " + ", ".join(
                    f"{kernel_name(k)} {ms:.4f} ms ({n} launches)"
                    for k, (ms, n) in parts.items()))
            del args
    return worst, times


def kernel_name(key: str) -> str:
    """``void (anonymous namespace)::f<T>(args)`` -> ``f<T>``."""
    m = re.search(r"(\w+(?:<[^>]*>)?)\(", key)
    return m.group(1) if m else key


def is_kernel(e) -> bool:
    """A profiler event that is a CUDA kernel with device time: not the
    device-side span of a user range (``record_function``, such as
    ``Optimizer.step``'s), which the profiler lists under the device too
    and which covers the gaps between the range's kernels."""
    from torch.autograd import DeviceType
    return (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False))


def range_device_ms(events, name: str) -> float:
    """Device ms of the kernels launched inside the host ranges ``name``
    (``prof.events()``), without the range's own device-side span."""
    from torch.autograd import DeviceType
    total = 0.0
    for e in events:
        if e.name == name and e.device_type == DeviceType.CPU:
            total += e.device_time_total - sum(
                k.duration for k in e.kernels if k.name == name)
    return total / 1e3


def device_ms_by_kernel(fn, calls: int = 10) -> dict:
    """{kernel: (mean device ms per call, launches recorded)} of every CUDA
    kernel that ``calls`` calls of ``fn`` run.  The profiler now and then
    drops a few device events (its activity buffer is not flushed): so a
    kernel's time per call is its mean time per recorded launch times its
    launches per call (recorded launches / calls, rounded), and a profiling
    run that recorded no device event at all is run again, at most twice."""
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
            if is_kernel(e):
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
    each loop's steady ms/frame, and that the bf16 backbone folded its
    weights once over both loops and launched BACKBONE_TAILS conv_tail
    kernels a frame.  Returns the model and the launch counts of the
    pipelined run."""
    from memotr_tpu_torch.models import resnet
    from memotr_tpu_torch.models.memotr import build_model
    from memotr_tpu_torch.ops import conv_tail

    model = random_weights_(build_model(config)).to(device).eval()
    builds, tails = resnet.fold_builds, conv_tail.launches
    runs = {loop: stream(tag, model, config, synthetic_frames(n_frames),
                         device, loop, no_sync=loop == "pipelined")
            for loop in ("pipelined", "sync")}
    tails = conv_tail.launches - tails
    assert resnet.fold_builds == builds + 1, \
        f"{tag}: backbone folded {resnet.fold_builds - builds} times"
    assert tails == 2 * BACKBONE_TAILS * n_frames, (tag, tails)
    say(tag, f"the backbone's weights folded once over both loops; "
        f"conv_tail launches {tails} = {BACKBONE_TAILS} x {n_frames} frames "
        f"x 2 loops ok")
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
    from memotr_tpu_torch.ops.window_attn import (window_attention,
                                                  window_attention_torch)
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
        """The kernel (through the op the main path calls), held against
        float64 beside the plain version."""
        out = window_attention(*args)
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
        if is_kernel(e):
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


def msda_filed_samples(loc, shapes) -> int:
    """Samples with a corner in the map (-1 < x W - 0.5 < W, and so for
    y): those K1 backward files, one integer atomic each."""
    n = 0
    for lvl, (h, w) in enumerate(shapes):
        px = loc[:, :, :, lvl, :, 0] * w - 0.5
        py = loc[:, :, :, lvl, :, 1] * h - 0.5
        n += int(((px > -1) & (py > -1) & (px < w) & (py < h)).sum())
    return n


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
        filed = msda_filed_samples(loc, shapes)
        say("11 K1 bwd", f"{name} bf16, per call over 20: device "
            f"{k_dev:.4f} ms (its msda_bwd kernels {kern:.4f}; event-timed "
            f"call {k_ms:.4f} ms), plain autograd backward device "
            f"{p_dev:.4f} ms (call {p_ms:.4f}), bound {b_ms:.4f} ms "
            f"({b_by}); route: cell buckets (grad_value gathered by row, "
            f"no buffer zeroed, no cast); atomics: {filed / 1e6:.3f} M int32 "
            f"atomicAdd (one a sample with a corner in the map, "
            f"msda_bwd_count_kernel), no float atomic")
        order = ("sample", "count", "scan_tiles", "scan_totals", "fill",
                 "cell", "row")
        step = {kernel_name(k): ms for k, (ms, _) in parts.items()}
        say("11 K1 bwd", f"{name} bf16 device time pass by pass: " + ", ".join(
            f"{k} {ms:.4f} ms" for k, ms in sorted(
                step.items(), key=lambda kv: next(
                    (i for i, o in enumerate(order)
                     if f"msda_bwd_{o}_kernel" in kv[0]), len(order)))))
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
    """The least time of K2's backward.  Its hand-written kernels: x, pos
    and the cotangent read, dQ, dK, dV written (in the activation dtype),
    the mask, the weights (in the activation dtype) and the bias table read
    and its gradient written; the four projections Q, K, V, dO (8 C^2 flops
    a token) and the five attention products (10 L C).  Whole call: x, pos
    and the cotangent read, g_x and g_pos written, the float32 weights read
    and their gradients written; the attention products and the VJP's
    projection products (16 C^2 flops a token: the four projections and
    the four gradient products)."""
    x, bias = args[0], args[7]
    c = x.shape[3]
    n, l, es = x.numel() // c, geo[1] * geo[2], x.element_size()
    table = 2 * bias.numel() * 4 if bias is not None else 0
    flops = 10 * n * l * c
    if whole:
        nbytes = 5 * n * c * es + n + 2 * (4 * c * c + 4 * c) * 4 + table
        flops += 16 * n * c * c
    else:
        nbytes = 6 * n * c * es + n + (4 * c * c + 3 * c) * es + table
        flops += 8 * n * c * c
    return bound(nbytes, flops, x.dtype)


def phase_k2_bwd(device):
    """K2 backward (through WindowAttnFunction) vs the plain version's
    autograd on the card; returns (max f32 error, times at the training
    canvas's shapes)."""
    from memotr_tpu_torch.ops import window_attn_cuda as wac
    from memotr_tpu_torch.ops.window_attn import (window_attention,
                                                  window_attention_torch)
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
            got = k2_grads(window_attention, leaves, args[2], geo, g)
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
        routes_before = dict(wac.bwd_routes)
        k_ms, k_dev, parts = timed(
            lambda: wac.window_attention_bwd(g, *args, o, *geo))
        route = [r for r, n in wac.bwd_routes.items()
                 if n > routes_before[r]]
        assert route and route[0].startswith("tensor_cores"), \
            f"{name}: bf16 at head dim 32 took the {route} route"
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
        say("14 K2 bwd", f"{name} 896x1536 bf16 (route {route[0]}: "
            f"Q/K/V/dO projected in the call, bias table in shared memory; "
            f"atomics: none, the bias gradient summed per block and its "
            f"partial tables in a fixed order), per "
            f"call over 20: whole backward device {k_dev:.4f} ms (its "
            f"hand-written kernels {kern:.4f}; "
            f"event-timed call {k_ms:.4f}), plain autograd backward device "
            f"{p_dev:.4f} ms (call {p_ms:.4f}), library composition's "
            f"autograd backward device {l_dev:.4f} ms (call {l_ms:.4f}); "
            f"bound whole {b_ms:.4f} ms ({b_by}), kernel {kb_ms:.4f} ms "
            f"({kb_by}): kernel at {kb_ms / kern:.1%} of its bound")
        say("14 K2 bwd", f"{name} bf16 device time by CUDA kernel (each "
            "pass of the call; the torch.matmul products, sums and copies "
            "around it): "
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
        if is_kernel(e):
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


# ------------------------------------------------------------ train entry
# phase 22: the port's training entry (memotr_tpu_torch.main --mode train)
# at the full width of configs/train_dancetrack.yaml, on a synthetic
# DanceTrack tree of 1920x1080 JPEGs.  SAMPLE_STEPS is the file's but for
# its first stage, which ends after epoch 0 so that epoch 1 takes clips of
# SAMPLE_LENGTHS[1] = 3 frames.
ENTRY_YAML = "configs/train_dancetrack.yaml"
ENTRY_WINDOWED_YAML = "configs/train_dancetrack_windowed.yaml"
ENTRY_HW = (1080, 1920)
ENTRY_VIDEOS = {"train": (("dancetrack0001", 6), ("dancetrack0002", 6)),
                "val": (("dancetrack0009", 6),)}
ENTRY_WINDOWED_VIDEOS = {"train": (("dancetrack0003", 5),)}
ENTRY_SAMPLE_STEPS = [1, 10, 14]
ENTRY_EPOCHS = 2
# submit thresholds: low enough that the seeded weights, trained 18 steps,
# keep detections in every run (ENTRY_SCORE_FLOOR's readings)
ENTRY_THRESH = 0.01
# the submit's first-frame rows against the model's own forward
# (entry_first_frame): a detection within ENTRY_SCORE_MARGIN of the
# threshold may fall either side of it (the two forwards round bf16
# differently), and a row's box lies within ENTRY_BOX_TOL of the frame's
# width and height of its detection's
ENTRY_SCORE_MARGIN = 5e-3
ENTRY_BOX_TOL = 5e-3
# the best first-frame detection score must clear this.  18 bf16 steps from
# the same inputs and seed leave it above and below ENTRY_THRESH from run
# to run (K1 backward's and cuDNN's sums, taken in a run-dependent order,
# move the training): 0.0492-0.359 on an H100 over the runs of
# scripts/entry_score_spread.py and of this script.  The floor catches a
# collapse, scores orders of magnitude down (a loss or a checkpoint gone
# wrong), not that spread: 2.5 times under the lowest reading, and over
# ENTRY_THRESH + ENTRY_SCORE_MARGIN, so that frame 1 always has rows to
# hold against the forward
ENTRY_SCORE_FLOOR = 0.02
# resume vs the unbroken run.  The resumed epoch's first iteration sees the
# same weights, optimizer state, generators and batch, so its losses equal
# the unbroken run's (forward: no atomics; float32 sums of a bf16 model in
# one order, to TRAIN_LOSS_RTOL).  After that the bf16 gradients differ in
# their last bits (K1 backward's cell sums and cuDNN's weight gradients
# take their terms in a run-dependent order), and Adam, which steps each
# element by about lr whatever its gradient's size, turns rounding-sized
# gradients into lr-sized steps of either sign, so the parameters are held
# only to 2 x LR x steps and a second resumed run is printed beside the
# first as the noise witness (an H100 read 0.436 of epoch 1's update in L2
# between two resumed runs, 0.364 against the unbroken one).  The restored
# optimizer state is held directly: at the resumed epoch's start it is
# checkpoint_0's bit for bit, and after its first step each parameter's
# exp_avg_sq sum is within RESUME_V_RTOL (bf16's 2^-8) of the unbroken
# run's after the same step, where a resume that dropped the moments would
# read about 1/11 of it.  After the epoch the sums are only printed: the
# same H100 read up to 0.65 apart, since matching and Adam's steps diverge.
RESUME_STEP_BOUND = 2
RESUME_V_RTOL = 2 ** -8


def write_tree(root: str, videos, seed: int, hw=ENTRY_HW) -> None:
    """A DanceTrack tree: per split, videos of n JPEG frames of 12 textured
    blocks moving over a textured background, and their gt.txt."""
    import cv2
    h, w = hw
    for split, vids in videos.items():
        for k, (name, n) in enumerate(vids):
            rng = np.random.default_rng(seed + k + 10 * len(split))
            n_obj = 12
            bg = rng.integers(40, 140, (h, w, 3), np.uint8)
            size = rng.uniform([0.04, 0.14], [0.13, 0.42], (n_obj, 2)) * [w, h]
            pos = rng.uniform(0, 1, (n_obj, 2)) * ([w, h] - size)
            vel = rng.uniform(-30, 30, (n_obj, 2))
            tex = [rng.integers(100, 255, (int(sh), int(sw), 3), np.uint8)
                   for sw, sh in size]
            vdir = os.path.join(root, "DanceTrack", split, name)
            os.makedirs(os.path.join(vdir, "img1"))
            os.makedirs(os.path.join(vdir, "gt"))
            lines = []
            for t in range(1, n + 1):
                img = bg.copy()
                for i in range(n_obj):
                    x, y = pos[i].astype(int)
                    th, tw = tex[i].shape[:2]
                    img[y:y + th, x:x + tw] = tex[i]
                    lines.append(f"{t},{i + 1},{x},{y},{tw},{th},1,1,1\n")
                assert cv2.imwrite(os.path.join(vdir, "img1", f"{t:08d}.jpg"),
                                   img)
                pos = np.clip(pos + vel, 0, [w, h] - size)
                vel[(pos <= 0) | (pos >= [w, h] - size)] *= -1
            with open(os.path.join(vdir, "gt", "gt.txt"), "w") as f:
                f.writelines(lines)


def entry_yaml(src: str, path: str) -> None:
    """``src`` with phase 22's SAMPLE_STEPS, written to ``path``."""
    from memotr_tpu_torch.config import dict_to_yaml, yaml_to_dict
    cfg = yaml_to_dict(src)
    cfg["SAMPLE_STEPS"] = ENTRY_SAMPLE_STEPS
    dict_to_yaml(cfg, path)


def adam_state(optimizer) -> dict:
    """CPU copies of ``optimizer``'s per-parameter state, by index."""
    return {i: {k: v.detach().to("cpu", copy=True) for k, v in st.items()}
            for i, st in optimizer.state_dict()["state"].items()}


def exp_avg_sq_rel_diff(a: dict, b: dict) -> float:
    """The largest relative difference, over parameters, of the summed
    ``exp_avg_sq`` of two AdamW states; every step count equal."""
    assert a.keys() == b.keys() and len(b) > 0
    worst = 0.0
    for i in b:
        assert torch.equal(a[i]["step"], b[i]["step"]), \
            (i, a[i]["step"], b[i]["step"])
        va, vb = (float(st[i]["exp_avg_sq"].double().sum()) for st in (a, b))
        worst = max(worst, abs(va - vb) / max(vb, 1e-30))
    return worst


def run_entry(argv, device, per_frame, profile_step=None, tag="22 train entry",
              adam=None, keep=(), kept=None):
    """``memotr_tpu_torch.main.main(argv)`` with each ``Trainer.step``'s
    kernel launches counted (set to 0 just before the step, read just
    after; each must be ``per_frame`` x T) and step ``profile_step`` traced
    by torch.profiler.  ``adam``, a dict keyed (step, "before" or
    "after"), gets ``adam_state`` at those points.  Returns (what main
    returns, [(T, counts)] a step, the profile's {"wall_ms", "busy_ms",
    "families", "teacher_ms", "top_kernels"}, peak GiB); ``top_kernels``:
    the TOP_KERNELS kernels of most device time, as (name, ms, launches);
    ``teacher_ms`` is the device
    time of the kernels launched inside ``TEACHER_RANGE`` ranges (phase
    24 opens one around each teacher forward).  The logs named in ``keep``
    go to ``kept`` as floats, a dict a step."""
    from torch.profiler import ProfilerActivity, profile

    from memotr_tpu_torch.engine.trainer import Trainer
    from memotr_tpu_torch.main import main as port_main
    orig = Trainer.step
    steps, prof = [], {}

    def counted_step(self, batch, epoch=0):
        t = batch["images"].shape[1]
        torch.cuda.synchronize()
        if adam is not None and (len(steps), "before") in adam:
            adam[len(steps), "before"] = adam_state(self.optimizer)
        reset_counts()
        if len(steps) == profile_step:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                t0 = time.perf_counter()
                logs = orig(self, batch, epoch)
                torch.cuda.synchronize()
                prof["wall_ms"] = (time.perf_counter() - t0) * 1e3
            fam = {}
            for e in p.key_averages():
                if is_kernel(e):
                    k = kernel_family(e.key)
                    fam[k] = fam.get(k, 0.0) + e.self_device_time_total / 1e3
            prof["busy_ms"] = sum(fam.values())
            prof["families"] = fam
            prof["teacher_ms"] = range_device_ms(p.events(), TEACHER_RANGE)
            prof["top_kernels"] = sorted(
                ((e.key, e.self_device_time_total / 1e3, e.count)
                 for e in p.key_averages() if is_kernel(e)),
                key=lambda kv: -kv[1])[:TOP_KERNELS]
        else:
            logs = orig(self, batch, epoch)
            torch.cuda.synchronize()
        counts = read_counts()
        if kept is not None:
            kept.append({k: float(logs[k]) for k in keep})
        if adam is not None and (len(steps), "after") in adam:
            adam[len(steps), "after"] = adam_state(self.optimizer)
        for kernel, n in per_frame.items():
            assert counts[kernel] == n * t, \
                f"{tag} step {len(steps)}: {kernel} launches " \
                f"{counts[kernel]}, expected {n} x {t}"
        steps.append((t, counts))
        return logs

    Trainer.step = counted_step
    torch.empty(0, device=device)          # the context, for a phase alone
    torch.cuda.reset_peak_memory_stats(device)
    try:
        out = port_main(argv + ["--device", str(device)])
    finally:
        Trainer.step = orig
    return out, steps, prof, torch.cuda.max_memory_allocated(device) / 2 ** 30


def entry_first_frame(config: dict, ckpt: str, seq_dir: str,
                      device) -> dict:
    """The detections of the model in ``ckpt`` on the first frame of
    ``seq_dir``, from a forward of its own (``model_forward`` on an empty
    TrackState with the eval cache's constants, as the Submitter's first
    frame runs it): each detection query's score, and its box as the
    submit writes it, (x, y, w, h) in the frame's pixels; with the frame's
    (height, width)."""
    from memotr_tpu_torch.config import cfg_get
    from memotr_tpu_torch.data.seq_dataset import SeqDataset
    from memotr_tpu_torch.engine.submit import normalize_uint8
    from memotr_tpu_torch.models.eval_cache import EvalCache
    from memotr_tpu_torch.models.frame_step import model_forward
    from memotr_tpu_torch.models.memotr import build_model
    from memotr_tpu_torch.structures.track_state import TrackState
    model = build_model(config)
    model.load_state_dict(torch.load(ckpt, map_location="cpu",
                                     weights_only=True)["model"])
    model.to(device).eval()
    frame = SeqDataset(seq_dir, cfg_get(config, "EVAL_SHORT_SIDE"),
                       cfg_get(config, "EVAL_MAX_SIDE"))[0]
    state = TrackState.empty(1, cfg_get(config, "TRACK_SLOTS"),
                             model.hidden_dim, model.num_classes,
                             use_dab=model.use_dab, device=device)
    mask = frame["mask"][None]
    with torch.inference_mode():
        out = model_forward(
            model, normalize_uint8(torch.from_numpy(frame["image"])[None]
                                   .to(device)),
            torch.from_numpy(mask).to(device), state,
            EvalCache(model, device).lookup(mask))
    n = model.n_det_queries
    scores = out["pred_logits"][0, :n].float().sigmoid().amax(-1)
    cx, cy, w, h = out["pred_boxes"][0, :n].float().cpu().numpy().T
    ori_h, ori_w = frame["ori_hw"]
    boxes = np.stack([(cx - w / 2) * ori_w, (cy - h / 2) * ori_h,
                      w * ori_w, h * ori_h], 1)
    return {"scores": scores.cpu().numpy(), "boxes": boxes,
            "hw": (ori_h, ori_w)}


def check_first_frame(rows, det: dict, slots: int) -> dict:
    """The submit's frame-1 ``rows`` are its newborn tracks: ``det``'s
    detections above ENTRY_THRESH take the ``slots`` free slots in query
    order (``models/runtime_tracker.newborn_candidates``, as JAX's
    ``insert_tracks``; the rest are dropped), and a slot is written when
    its box's area is over the submit's 100 pixels.  A detection within
    ENTRY_SCORE_MARGIN of the threshold, or within 10 pixels of that area,
    may fall either side of it (the two forwards round bf16 differently).
    Only the detections that can reach a slot count: those in query order
    up to the ``slots``-th sure one, since the sure ones take a slot
    whatever the others do.  Each ambiguous one among them moves the row
    count by at most one.  Each row's box lies within ENTRY_BOX_TOL of a
    detection's of its own among those.  Returns the counts and the
    largest box difference."""
    scores, boxes = det["scores"], det["boxes"]
    area = boxes[:, 2] * boxes[:, 3]
    sure = scores > ENTRY_THRESH + ENTRY_SCORE_MARGIN
    maybe = scores > ENTRY_THRESH - ENTRY_SCORE_MARGIN
    cand = np.nonzero(maybe)[0]
    n_sure = np.cumsum(sure[cand])
    window = cand[:int(np.searchsorted(n_sure, slots)) + 1]
    n_amb = int((~sure[window]).sum()
                + (np.abs(area[window] - 100) <= 10).sum())
    expect = int((area[np.nonzero(sure)[0][:slots]] > 100).sum())
    first = [np.array(r[2:6]) for r in rows if r[0] == 1]
    lo, hi = max(expect - n_amb, 0), min(expect + n_amb, slots)
    assert lo <= len(first) <= hi, \
        f"frame 1: {len(first)} rows, slot-taking detections above " \
        f"{ENTRY_THRESH} with an area over 100 px: {lo}-{hi}"
    h, w = det["hw"]
    tol = ENTRY_BOX_TOL * np.array([w, h, w, h], float)
    free = set(window.tolist())
    worst = 0.0
    for box in first:
        j = min(free, key=lambda k: np.abs(boxes[k] - box).max())
        diff = np.abs(boxes[j] - box)
        assert (diff <= tol).all(), (box, boxes[j])
        free.discard(j)
        worst = max(worst, float(diff.max()))
    return {"rows": len(first), "detections": [lo, hi],
            "window": len(window),
            "above_threshold": int(sure.sum()), "max_box_diff_px": worst}


def check_moved(tag, model, pretrained) -> None:
    """Every trainable parameter moved away from ``pretrained``, every
    frozen one did not."""
    from memotr_tpu_torch.engine.trainer import param_group_label
    moved = frozen = 0
    for name, p in model.named_parameters():
        before = pretrained[name].to(p.device)
        if param_group_label(name) == "frozen":
            assert torch.equal(p.detach(), before), name
            frozen += 1
        else:
            assert not torch.equal(p.detach(), before), name
            moved += 1
    say(tag, f"all {moved} trainable parameters moved from the pretrained "
        f"ones, the {frozen} frozen ones did not")


def mot_lines(out_dir: str, split: str) -> dict:
    tracker = os.path.join(out_dir, split, "tracker")
    return {f: mot_rows(os.path.join(tracker, f))
            for f in sorted(os.listdir(tracker))}


def entry_inputs(tmp: str) -> tuple:
    """Phase 22's inputs in ``tmp``: the DanceTrack tree (ENTRY_VIDEOS),
    the YAML (ENTRY_YAML with ENTRY_SAMPLE_STEPS), the seeded random
    weights as a reference-format .pth; returns (data root, YAML path,
    .pth path, the training command line's common options)."""
    from memotr_tpu_torch.config import yaml_to_dict
    from memotr_tpu_torch.models.memotr import build_model
    root = os.path.join(tmp, "datasets")
    write_tree(root, ENTRY_VIDEOS, seed=50)
    yaml_path = os.path.join(tmp, "train_dancetrack.yaml")
    entry_yaml(ENTRY_YAML, yaml_path)
    pretrained = os.path.join(tmp, "pretrained.pth")
    model = random_weights_(build_model(yaml_to_dict(yaml_path)))
    torch.save({"model": model.state_dict()}, pretrained)
    common = ["--config-path", yaml_path, "--data-root", root,
              "--pretrained-model", pretrained, "--epochs",
              str(ENTRY_EPOCHS)]
    return root, yaml_path, pretrained, common


def entry_per_frame(cfg: dict) -> dict:
    """The deformable training step's kernel launches a frame."""
    enc_dec = cfg["NUM_ENC_LAYERS"] + cfg["NUM_DEC_LAYERS"]
    return {"msda_fwd": enc_dec, "msda_bwd": enc_dec,
            "window_attn_fwd": 0, "window_attn_bwd": 0}


def phase_train_entry(device, tmp=None):
    """Phase 22: train, resume and submit through the port's CLI, then the
    windowed flagship through the same entry, in ``tmp`` (a temporary
    directory, removed after, when None).  Returns the numbers for the
    result lines and, under ``"paths"``, the trees, YAML files and runs
    that phases 23 and 24 go on with."""
    from memotr_tpu_torch.checkpoint.files import load_checkpoint
    from memotr_tpu_torch.config import yaml_to_dict
    from memotr_tpu_torch.data import build_dataset, native
    from memotr_tpu_torch.data.seq_dataset import SeqDataset
    tag = "22 train entry"
    res = {}
    if tmp is None:
        with tempfile.TemporaryDirectory() as tmp:
            return phase_train_entry(device, tmp)
    t0 = time.perf_counter()
    root, yaml_path, pretrained, common = entry_inputs(tmp)
    cfg = yaml_to_dict(yaml_path)
    say(tag, f"inputs: {sum(n for v in ENTRY_VIDEOS.values() for _, n in v)}"
        f" JPEG frames {ENTRY_HW[1]}x{ENTRY_HW[0]} in "
        f"{len(ENTRY_VIDEOS['train'])} train and "
        f"{len(ENTRY_VIDEOS['val'])} val videos, a reference-format .pth "
        f"of random_weights_ as PRETRAINED_MODEL, {ENTRY_YAML} with "
        f"SAMPLE_STEPS {ENTRY_SAMPLE_STEPS} (NUM_WORKERS "
        f"{cfg['NUM_WORKERS']}, DTYPE {cfg['DTYPE']}, SAMPLE_INTERVALS "
        f"{cfg['SAMPLE_INTERVALS']}), in {time.perf_counter() - t0:.1f} s")
    enc_dec = cfg["NUM_ENC_LAYERS"] + cfg["NUM_DEC_LAYERS"]
    per_frame = entry_per_frame(cfg)
    out = os.path.join(tmp, "run")
    t0 = time.perf_counter()
    unbroken_adam = {(10, "after"): None}    # epoch 1's first step
    run, steps, prof, peak = run_entry(
        common + ["--mode", "train", "--outputs-dir", out], device,
        per_frame, profile_step=12, adam=unbroken_adam)
    wall = time.perf_counter() - t0
    n = len(steps)
    say(tag, f"trained {n} steps over {ENTRY_EPOCHS} epochs in "
        f"{wall:.1f} s: T per step {[t for t, _ in steps]}; "
        f"msda_fwd and msda_bwd {enc_dec} x T every step ok "
        f"(totals {sum(c['msda_fwd'] for _, c in steps)} / "
        f"{sum(c['msda_bwd'] for _, c in steps)})")
    assert run.states == {"start_epoch": ENTRY_EPOCHS, "global_iters": n}
    assert [t for t, _ in steps] == [2] * 10 + [3] * 8, steps
    with open(os.path.join(out, "train", "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    assert len(scalars) == ENTRY_EPOCHS
    for rec in scalars:
        assert np.isfinite(rec["total_loss"]), rec
    for e in range(ENTRY_EPOCHS):
        assert os.path.exists(os.path.join(out, f"checkpoint_{e}.pth")), e
    say(tag, f"scalars.jsonl total_loss {[r['total_loss'] for r in scalars]}"
        f" (finite); checkpoint_0.pth and checkpoint_1.pth written")
    check_moved(tag, run.trainer.model,
                torch.load(pretrained, weights_only=True)["model"])
    pre = run.pretrain
    assert pre["shape_mismatch"] == pre["encoder_skipped"] == 0, pre
    # steady iterations: not the first of an epoch, not the profiled one
    firsts = {0, 10}
    steady = [i for i in range(n) if i not in firsts | {12}]
    it_ms = [1e3 * (run.wait_seconds[i] + run.step_seconds[i])
             for i in steady]
    wait_ms = [1e3 * run.wait_seconds[i] for i in steady]
    share = sum(wait_ms) / sum(it_ms)
    idle = 1 - prof["busy_ms"] / prof["wall_ms"]
    res["train"] = {
        "iteration_ms": float(np.mean(it_ms)),
        "iteration_ms_by_T": {
            t: float(np.mean([it_ms[j] for j, i in enumerate(steady)
                              if steps[i][0] == t])) for t in (2, 3)},
        "loader_wait_ms": float(np.mean(wait_ms)),
        "loader_wait_share": share,
        "loader_first_wait_ms": [1e3 * run.wait_seconds[i]
                                 for i in sorted(firsts)],
        "peak_gib": peak, "idle_share": idle,
        "profiled_wall_ms": prof["wall_ms"],
        "profiled_busy_ms": prof["busy_ms"],
        "steps": n, "pretrain": pre}
    say(tag, f"host wall per steady iteration {np.mean(it_ms):.1f} ms "
        f"(T=2 {res['train']['iteration_ms_by_T'][2]:.1f}, T=3 "
        f"{res['train']['iteration_ms_by_T'][3]:.1f}; {len(steady)} "
        f"iterations); loader wait {np.mean(wait_ms):.1f} ms an "
        f"iteration, {share:.1%} of it (first iteration of each epoch: "
        f"{res['train']['loader_first_wait_ms']} ms); peak device memory "
        f"{peak:.2f} GiB")
    say(tag, f"profiled iteration 12 (T=3): host wall {prof['wall_ms']:.1f}"
        f" ms under the profiler, device busy {prof['busy_ms']:.1f} ms, "
        f"idle share {idle:.3f}")
    for k, v in sorted(prof["families"].items(), key=lambda kv: -kv[1]):
        say(tag, f"  {k}: {v:.2f} ms ({v / prof['busy_ms']:.1%} of busy)")

    # resume from the epoch-0 checkpoint, epoch 1 only, twice: the
    # second run is the first's noise witness
    t0 = time.perf_counter()
    resumed = []
    for name in ("resumed", "resumed2"):
        rdir = os.path.join(tmp, name)
        radam = {(0, "before"): None, (0, "after"): None}
        rrun, rsteps, _, _ = run_entry(
            common + ["--mode", "train", "--outputs-dir", rdir,
                      "--resume", os.path.join(out, "checkpoint_0.pth")],
            device, per_frame, adam=radam)
        assert [t for t, _ in rsteps] == [3] * 8, rsteps
        assert rrun.states == run.states, (rrun.states, run.states)
        assert not os.path.exists(os.path.join(rdir, "checkpoint_0.pth"))
        with open(os.path.join(rdir, "train", "scalars.jsonl")) as f:
            first = json.loads(f.readline())
        resumed.append((load_checkpoint(
            os.path.join(rdir, "checkpoint_1.pth")), first, radam))
    (a, first, radam), (a2, _, radam2) = resumed
    b = load_checkpoint(os.path.join(out, "checkpoint_1.pth"))
    c = load_checkpoint(os.path.join(out, "checkpoint_0.pth"))
    assert a["states"] == a2["states"] == b["states"] == run.states, \
        (a["states"], b["states"])
    want = scalars[1]
    assert first["step"] == want["step"] == 10, (first, want)
    losses = [k for k in want if k.endswith("loss")]
    for k in losses:
        assert abs(first[k] - want[k]) <= TRAIN_LOSS_RTOL * abs(want[k]), \
            (k, first[k], want[k])
    # the restored AdamW state: checkpoint_0's, bit for bit, when the
    # resumed epoch starts; after its first step, the unbroken run's
    # after the same step (the same state, gradients that differ in
    # their last bits); after the epoch, the step counts
    for st in (radam, radam2):
        restored, saved = st[0, "before"], c["optimizer"]["state"]
        assert restored.keys() == saved.keys() and len(saved) > 0
        for i in saved:
            for k, v in saved[i].items():
                assert torch.equal(restored[i][k], v.cpu()), (i, k)
    v_first = exp_avg_sq_rel_diff(radam[0, "after"],
                                  unbroken_adam[10, "after"])
    v_first_witness = exp_avg_sq_rel_diff(radam2[0, "after"],
                                          radam[0, "after"])
    v_epoch = exp_avg_sq_rel_diff(a["optimizer"]["state"],
                                  b["optimizer"]["state"])
    v_epoch_witness = exp_avg_sq_rel_diff(a2["optimizer"]["state"],
                                          a["optimizer"]["state"])
    steps_b = sorted({int(st["step"])
                      for st in b["optimizer"]["state"].values()})
    names = [k for k, p in run.trainer.model.named_parameters()
             if p.requires_grad]
    moved = torch.cat([(b["model"][k] - c["model"][k]).flatten()
                       for k in names])

    def param_diff(x, y):
        d = torch.cat([(x["model"][k] - y["model"][k]).flatten()
                       for k in names])
        return float(d.abs().max()), float(d.norm() / moved.norm())

    worst, rel = param_diff(a, b)
    noise_worst, noise_rel = param_diff(a, a2)
    bound = RESUME_STEP_BOUND * cfg["LR"] * 8
    res["resume"] = {
        "max_abs_diff": worst, "bound": bound, "rel_l2_of_update": rel,
        "witness_max_abs_diff": noise_worst,
        "witness_rel_l2_of_update": noise_rel,
        "adam_steps": steps_b,
        "exp_avg_sq_first_step_rel_diff": v_first,
        "exp_avg_sq_first_step_witness": v_first_witness,
        "exp_avg_sq_rtol": RESUME_V_RTOL,
        "exp_avg_sq_epoch_rel_diff": v_epoch,
        "exp_avg_sq_epoch_witness": v_epoch_witness}
    say(tag, f"resume from checkpoint_0.pth, twice: 8 steps of epoch 1 "
        f"each, {time.perf_counter() - t0:.1f} s both; states "
        f"{a['states']} as the unbroken run's; the first iteration's "
        f"{len(losses)} losses equal the unbroken run's (total_loss "
        f"{first['total_loss']} vs {want['total_loss']}); AdamW state "
        f"at the resumed epoch's start equals checkpoint_0's bit for "
        f"bit; after its first step, exp_avg_sq sums within "
        f"{v_first:.3e} of the unbroken run's (rtol {RESUME_V_RTOL:.3e}; "
        f"second resumed run vs the first {v_first_witness:.3e}); after "
        f"the epoch, step counts {steps_b} equal for all "
        f"{len(b['optimizer']['state'])} parameters, exp_avg_sq sums "
        f"within {v_epoch:.3e} (witness {v_epoch_witness:.3e}); "
        f"parameters vs the unbroken run: max |diff| {worst:.3e} (bound "
        f"{bound:.1e}), L2 {rel:.3e} of epoch 1's update; second resumed "
        f"run vs the first (noise witness): max |diff| {noise_worst:.3e},"
        f" L2 {noise_rel:.3e}")
    assert v_first <= RESUME_V_RTOL, (v_first, RESUME_V_RTOL)
    assert worst <= bound, (worst, bound)

    # submit the val split from checkpoint_1.pth
    t0 = time.perf_counter()
    det = entry_first_frame(
        yaml_to_dict(yaml_path), os.path.join(out, "checkpoint_1.pth"),
        os.path.join(root, "DanceTrack", "val", ENTRY_VIDEOS["val"][0][0]),
        device)
    best = float(det["scores"].max())
    thresh = str(ENTRY_THRESH)
    from memotr_tpu_torch.main import main as port_main
    port_main(["--config-path", yaml_path, "--data-root", root,
               "--mode", "submit", "--submit-dir", out, "--submit-model",
               "checkpoint_1.pth", "--submit-data-split", "val",
               "--det-score-thresh", thresh, "--track-score-thresh",
               thresh, "--result-score-thresh", thresh,
               "--device", str(device)])
    txts = mot_lines(out, "val")
    want = [f"{name}.txt" for name, _ in ENTRY_VIDEOS["val"]]
    assert list(txts) == want, txts
    for name, rows in txts.items():
        assert {r[0] for r in rows} <= set(range(1, 7)), name
    first = check_first_frame(txts[want[0]], det, cfg["TRACK_SLOTS"])
    assert best >= ENTRY_SCORE_FLOOR, (best, ENTRY_SCORE_FLOOR)
    assert first["rows"] > 0, first
    decode = SeqDataset(os.path.join(root, "DanceTrack", "val",
                                     ENTRY_VIDEOS["val"][0][0])).decode_path
    assert decode == ("native" if native.available() else "python")
    res["submit"] = {"lines": {k: len(v) for k, v in txts.items()},
                     "best_score": best, "first_frame": first,
                     "decode": decode,
                     "native_unavailable": None if native.available()
                     else native.unavailable_reason()}
    say(tag, f"submit from checkpoint_1.pth in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {len(v)} MOT lines" for k, v in txts.items())
        + f" (thresholds {thresh}); frame 1: {first['rows']} rows, "
        f"the model's own forward {first['above_threshold']} detections "
        f"above it, {first['detections'][0]}-{first['detections'][1]} of "
        f"the {cfg['TRACK_SLOTS']} slot-takers over 100 px (boxes within "
        f"{first['max_box_diff_px']:.3g} px), best score {best:.4f} (floor "
        f"{ENTRY_SCORE_FLOOR}); frames decoded by the {decode} path"
        + ("" if native.available() else
           f" (native data plane unavailable here: "
           f"{native.unavailable_reason()})"))

    # the Data layer alone: every training clip of each epoch, loaded
    # once on this thread
    dataset = build_dataset(dict(cfg, DATA_ROOT=root), split="train")
    clip_ms = {}
    for epoch in range(ENTRY_EPOCHS):
        dataset.set_epoch(epoch)
        ms = []
        for j in range(len(dataset)):
            t0 = time.perf_counter()
            clip = dataset.get(j)
            ms.append((time.perf_counter() - t0) * 1e3)
        clip_ms[len(clip["imgs"])] = ms
    res["data"] = {"clip_ms_by_T": {t: float(np.mean(v))
                                    for t, v in clip_ms.items()},
                   "frame_ms": float(np.mean([m / t for t, v in
                                              clip_ms.items()
                                              for m in v])),
                   "clips": sum(len(v) for v in clip_ms.values())}
    say(tag, "Data layer: ClipDataset.get on one host thread, "
        + ", ".join(f"T={t}: {np.mean(v):.1f} ms a clip over {len(v)}"
                    for t, v in clip_ms.items())
        + f"; {res['data']['frame_ms']:.1f} ms a {ENTRY_HW[1]}x"
        f"{ENTRY_HW[0]} frame (decode, MOTR_SCALES transforms)")

    # the windowed flagship through the same entry: one 5-frame video
    wroot = os.path.join(tmp, "windowed_data")
    write_tree(wroot, ENTRY_WINDOWED_VIDEOS, seed=70)
    wyaml = os.path.join(tmp, "train_dancetrack_windowed.yaml")
    entry_yaml(ENTRY_WINDOWED_YAML, wyaml)
    wcfg = yaml_to_dict(wyaml)
    levels = wcfg["NUM_ENC_LAYERS"] * wcfg["NUM_FEATURE_LEVELS"]
    wper = {"window_attn_fwd": levels, "window_attn_bwd": levels,
            "msda_fwd": wcfg["NUM_DEC_LAYERS"],
            "msda_bwd": wcfg["NUM_DEC_LAYERS"]}
    t0 = time.perf_counter()
    wrun, wsteps, _, wpeak = run_entry(
        ["--config-path", wyaml, "--data-root", wroot, "--mode", "train",
         "--outputs-dir", os.path.join(tmp, "windowed"), "--epochs", "1",
         "--pretrained-model", pretrained], device, wper,
        tag="22 windowed entry")
    assert [t for t, _ in wsteps] == [2] * 4, wsteps
    assert wrun.pretrain["encoder_skipped"] > 0, wrun.pretrain
    res["windowed"] = {"steps": len(wsteps), "pretrain": wrun.pretrain,
                       "peak_gib": wpeak, "iteration_ms": float(np.mean(
                           [1e3 * (w + s) for w, s in zip(
                               wrun.wait_seconds[1:],
                               wrun.step_seconds[1:])]))}
    say("22 windowed entry", f"{ENTRY_WINDOWED_YAML}: {len(wsteps)} steps "
        f"T=2 in {time.perf_counter() - t0:.1f} s; per step "
        + ", ".join(f"{k} {n} x T" for k, n in wper.items())
        + f" launches ok; pretrain from the deformable .pth "
        f"{wrun.pretrain} (encoder skipped); "
        f"{res['windowed']['iteration_ms']:.1f} ms an iteration after "
        f"the first; peak {wpeak:.2f} GiB")
    res["counts"] = {k: sum(c[k] for _, c in steps) for k in per_frame}
    res["windowed_counts"] = {k: sum(c[k] for _, c in wsteps)
                              for k in wper}
    res["windowed_per_frame"] = wper
    res["paths"] = {"tmp": tmp, "root": root, "yaml": yaml_path, "run": out,
                    "pretrained": pretrained, "windowed_root": wroot,
                    "windowed_yaml": wyaml}
    return res


# phase 23: the metrics' process pool must finish within this, so that a
# deadlocked pool fails the phase instead of hanging the run
EVAL_POOL_TIMEOUT = 300
EVAL_SUMMARY = ("HOTA", "DetA", "AssA", "MOTA", "IDF1")
# phase 24: the profiler range around each teacher forward
TEACHER_RANGE = "distill teacher"
TOP_KERNELS = 12


def run_with_timeout(fn, seconds: float, what: str):
    """``fn()`` on a daemon thread; raises if it has not returned within
    ``seconds``."""
    box = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as e:            # re-raised on this thread
            box["error"] = e
    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(seconds)
    if th.is_alive():
        raise AssertionError(f"{what} did not finish within {seconds} s")
    if "error" in box:
        raise box["error"]
    return box["value"]


def phase_eval(device, paths):
    """Phase 23: ``memotr_tpu_torch.main --mode eval`` on phase 22's run:
    ``specific`` on checkpoint_1.pth, then ``continue`` over both epoch
    checkpoints, on the val split (1920x1080 JPEGs at short side 800; 12 K1
    launches a frame); then
    the train split's GT scored as a tracker through
    ``evaluate_mot_challenge`` with ``num_parallel`` 8 (a spawned pool of
    2, after CUDA and the loader's and submitter's threads have run), which
    must read 100.  Returns the numbers for the result line."""
    import yaml

    from memotr_tpu_torch.config import yaml_to_dict
    from memotr_tpu_torch.data.seq_dataset import SeqDataset
    from memotr_tpu_torch.engine import eval as port_eval
    from memotr_tpu_torch.engine import submit as port_submit
    from memotr_tpu_torch.main import main as port_main
    from memotr_tpu_torch.metrics import evaluate_mot_challenge
    tag = "23 eval"
    root, out = paths["root"], paths["run"]
    cfg = yaml_to_dict(paths["yaml"])
    per_frame = cfg["NUM_ENC_LAYERS"] + cfg["NUM_DEC_LAYERS"]
    val_names = [name for name, _ in ENTRY_VIDEOS["val"]]
    canvas = SeqDataset(os.path.join(root, "DanceTrack", "val", val_names[0]),
                        cfg["EVAL_SHORT_SIDE"], cfg["EVAL_MAX_SIDE"]
                        ).padded_canvas()
    n_frames = sum(n for _, n in ENTRY_VIDEOS["val"])
    thresh = str(ENTRY_THRESH)
    argv = ["--config-path", paths["yaml"], "--data-root", root,
            "--mode", "eval", "--eval-dir", out, "--eval-data-split", "val",
            "--det-score-thresh", thresh, "--track-score-thresh", thresh,
            "--result-score-thresh", thresh, "--device", str(device)]
    frame_s, metric_s = [], []
    run, score = port_submit.Submitter.run, port_eval.evaluate_mot_challenge

    def timed_run(self):
        r = run(self)
        frame_s.append(list(self.frame_seconds))
        return r

    def timed_score(*args, **kwargs):
        t0 = time.perf_counter()
        m = score(*args, **kwargs)
        metric_s.append(time.perf_counter() - t0)
        return m

    def no_sleep(seconds):
        raise AssertionError(f"{tag}: continue mode waited for a checkpoint")
    port_submit.Submitter.run = timed_run
    port_eval.evaluate_mot_challenge = timed_score
    sleep, port_eval.time.sleep = port_eval.time.sleep, no_sleep
    res = {}
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        metrics = port_main(argv + ["--eval-mode", "specific",
                                    "--eval-model", "checkpoint_1.pth"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        assert counts == {"msda_fwd": per_frame * n_frames, "msda_bwd": 0,
                          "window_attn_fwd": 0, "window_attn_bwd": 0}, counts
        val = os.path.join(out, "val")
        tracker = os.path.join(val, "checkpoint_1_tracker")
        assert sorted(os.listdir(tracker)) == sorted(
            [f"{n}.txt" for n in val_names] + ["pedestrian_summary.txt"]), \
            os.listdir(tracker)
        assert not os.path.exists(os.path.join(val, "tracker"))
        with open(os.path.join(val, "checkpoint_1_metrics.json")) as f:
            np.testing.assert_equal(json.loads(f.read()),
                                    {k: float(v) for k, v in metrics.items()})
        for k in EVAL_SUMMARY:
            assert np.isfinite(metrics[k]), (k, metrics[k])
        ms = steady_ms(frame_s[0])
        res["specific"] = {
            "wall_s": wall, "canvas": list(canvas),
            "frame_ms": float(np.mean(ms)),
            "frame_ms_all": [1e3 * s for s in frame_s[0]],
            "metrics_s_per_sequence": metric_s[0] / len(val_names),
            "launches": counts["msda_fwd"],
            **{k: float(metrics[k]) for k in EVAL_SUMMARY}}
        say(tag, f"specific, checkpoint_1.pth: {wall:.1f} s; submit "
            f"{np.mean(ms):.1f} ms a frame on the {canvas[0]}x{canvas[1]} "
            f"canvas (frames 3-{n_frames}, pipelined); msda_fwd {counts['msda_fwd']} = {per_frame} x "
            f"{n_frames} frames; metrics {metric_s[0]:.3f} s for "
            f"{len(val_names)} sequence(s); "
            + ", ".join(f"{k} {metrics[k]:.3f}" for k in EVAL_SUMMARY)
            + " (finite); val/checkpoint_1_tracker/ with "
            "pedestrian_summary.txt, val/checkpoint_1_metrics.json")

        states_path = os.path.join(out, "eval_states.yaml")
        assert not os.path.exists(states_path)
        reset_counts()
        t0 = time.perf_counter()
        port_main(argv + ["--eval-mode", "continue",
                          "--epochs", str(ENTRY_EPOCHS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        port_submit.Submitter.run = run
        port_eval.evaluate_mot_challenge = score
        port_eval.time.sleep = sleep
    assert counts["msda_fwd"] == per_frame * n_frames * ENTRY_EPOCHS, counts
    with open(states_path) as f:
        assert yaml.safe_load(f) == {"last": ENTRY_EPOCHS - 1}
    by_epoch = {}
    for e in range(ENTRY_EPOCHS):
        assert os.path.isfile(os.path.join(val, f"checkpoint_{e}_tracker",
                                           "pedestrian_summary.txt")), e
        with open(os.path.join(val, f"checkpoint_{e}_metrics.json")) as f:
            m = json.loads(f.read())
        for k in EVAL_SUMMARY:
            assert np.isfinite(m[k]), (e, k, m[k])
        by_epoch[e] = {k: m[k] for k in EVAL_SUMMARY}
    with open(os.path.join(val, "scalars.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [1] + list(range(ENTRY_EPOCHS)), steps
    same = by_epoch[1] == {k: res["specific"][k] for k in EVAL_SUMMARY}
    res["continue"] = {"wall_s": wall, "launches": counts["msda_fwd"],
                       "metrics": by_epoch, "checkpoint_1_as_specific": same}
    say(tag, f"continue over checkpoint_0.pth and checkpoint_1.pth: {wall:.1f}"
        f" s; msda_fwd {counts['msda_fwd']} = {per_frame} x {n_frames} x "
        f"{ENTRY_EPOCHS}; eval_states.yaml last {ENTRY_EPOCHS - 1}; HOTA by "
        f"epoch {[by_epoch[e]['HOTA'] for e in range(ENTRY_EPOCHS)]}; "
        f"checkpoint_1 as in specific mode: {same}")

    # the train split's GT as a tracker: a pool of 2 after CUDA is up
    gt_dir = os.path.join(root, "DanceTrack", "train")
    as_tracker = os.path.join(paths["tmp"], "gt_as_tracker")
    os.makedirs(as_tracker)
    for name, _ in ENTRY_VIDEOS["train"]:
        shutil.copy(os.path.join(gt_dir, name, "gt", "gt.txt"),
                    os.path.join(as_tracker, f"{name}.txt"))
    t0 = time.perf_counter()
    pooled = run_with_timeout(
        lambda: evaluate_mot_challenge(gt_dir, as_tracker, num_parallel=8),
        EVAL_POOL_TIMEOUT, f"{tag}: the metrics' process pool")
    pool_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serial = evaluate_mot_challenge(gt_dir, as_tracker, num_parallel=1)
    serial_s = time.perf_counter() - t0
    for k in ("HOTA", "MOTA", "IDF1"):
        assert abs(pooled[k] - 100.0) <= 1e-9, (k, pooled[k])
    assert pooled == serial
    res["gt_as_tracker"] = {"pool_s": pool_s, "serial_s": serial_s,
                            "sequences": len(ENTRY_VIDEOS["train"]),
                            **{k: pooled[k] for k in ("HOTA", "MOTA",
                                                      "IDF1")}}
    say(tag, f"train GT scored as a tracker, num_parallel 8 (a spawned pool "
        f"of {len(ENTRY_VIDEOS['train'])}): HOTA {pooled['HOTA']}, MOTA "
        f"{pooled['MOTA']}, IDF1 {pooled['IDF1']}; pool wall {pool_s:.2f} s "
        f"(in this process: {serial_s:.2f} s, the same dict)")
    return res


def phase_distill(device, paths, windowed_per_frame, no_teacher_ms):
    """Phase 24: the windowed flagship of phase 22 (the same tree, YAML and
    pretrained .pth) learns from phase 22's deformable checkpoint_1.pth
    through ``memotr_tpu_torch.main --mode train --distill-teacher``: 4
    steps at T=2, each with the teacher's K1 forward launches on top of
    the windowed run's; finite distillation terms above 0 every step, the
    teacher untouched and outside the student.  Returns the numbers for
    the result line."""
    from torch.profiler import record_function

    from memotr_tpu_torch.checkpoint.files import load_checkpoint
    from memotr_tpu_torch.config import yaml_to_dict
    from memotr_tpu_torch.engine import trainer as port_trainer
    tag = "24 distill"
    teacher_path = os.path.join(paths["run"], "checkpoint_1.pth")
    t_cfg = yaml_to_dict(os.path.join(paths["run"], "train", "config.yaml"))
    t_frame = t_cfg["NUM_ENC_LAYERS"] + t_cfg["NUM_DEC_LAYERS"]
    per_frame = dict(windowed_per_frame,
                     msda_fwd=windowed_per_frame["msda_fwd"] + t_frame)
    out = os.path.join(paths["tmp"], "distilled")
    argv = ["--config-path", paths["windowed_yaml"], "--data-root",
            paths["windowed_root"], "--mode", "train", "--epochs", "1",
            "--pretrained-model", paths["pretrained"]]
    steady = [1, 2]          # not the first, not the profiled one (3)

    def iteration_ms(run):
        return float(np.mean([1e3 * (run.wait_seconds[i]
                                     + run.step_seconds[i]) for i in steady]))

    def without_teacher(name):
        """The same windowed run without a teacher (in turns with the
        distilled one: before and after it)."""
        run, _, prof, _ = run_entry(
            argv + ["--outputs-dir", os.path.join(paths["tmp"], name)],
            device, windowed_per_frame, profile_step=3, tag=tag)
        return iteration_ms(run), prof["busy_ms"]

    base_before = without_teacher("undistilled_before")
    forward, last_call, host_s = port_trainer.model_forward, [], []

    def teacher_forward(*args):
        last_call[:] = args
        t = time.perf_counter()
        with record_function(TEACHER_RANGE):
            out = forward(*args)
        host_s.append(time.perf_counter() - t)
        return out
    port_trainer.model_forward = teacher_forward
    terms = []
    t0 = time.perf_counter()
    try:
        run, steps, prof, peak = run_entry(
            argv + ["--outputs-dir", out, "--distill-teacher", teacher_path],
            device, per_frame, profile_step=3, tag=tag,
            keep=port_trainer.DISTILL_KEYS, kept=terms)
    finally:
        port_trainer.model_forward = forward
    wall = time.perf_counter() - t0
    base_after = without_teacher("undistilled_after")
    # the teacher's forward alone, warm, on the last frame it saw
    with torch.no_grad():
        alone = device_ms_by_kernel(lambda: forward(*last_call), calls=3)
    alone_ms = sum(ms for ms, _ in alone.values())
    alone_top = sorted(((k, ms) for k, (ms, _) in alone.items()),
                       key=lambda kv: -kv[1])[:TOP_KERNELS]
    assert [t for t, _ in steps] == [2] * 4, steps
    assert len(terms) == 4
    for i, rec in enumerate(terms):
        for k, v in rec.items():
            assert np.isfinite(v) and v > 0, (i, k, v)
    with open(os.path.join(out, "train", "scalars.jsonl")) as f:
        for rec in map(json.loads, f):
            for k in port_trainer.DISTILL_KEYS:
                assert np.isfinite(rec[k]) and rec[k] > 0, (k, rec)
    teacher = run.trainer.distill["model"]
    saved = load_checkpoint(teacher_path)["model"]
    for k, v in teacher.state_dict().items():
        assert torch.equal(v.cpu(), saved[k]), k
    assert not teacher.training
    assert all(not p.requires_grad and p.grad is None
               for p in teacher.parameters())
    in_opt = {id(p) for g in run.trainer.optimizer.param_groups
              for p in g["params"]}
    assert not in_opt & {id(p) for p in teacher.parameters()}
    ckpt = load_checkpoint(os.path.join(out, "checkpoint_0.pth"))
    assert set(ckpt["model"]) == set(run.trainer.model.state_dict())
    it_ms = iteration_ms(run)
    # the host's dispatch of one teacher forward (it returns before the
    # device finishes), over the steady steps' frames
    host_ms = 1e3 * float(np.mean([host_s[2 * i + f] for i in steady
                                   for f in range(2)]))
    idle = 1 - prof["busy_ms"] / prof["wall_ms"]
    share = prof["teacher_ms"] / prof["busy_ms"]
    res = {"steps": len(steps), "wall_s": wall, "iteration_ms": it_ms,
           "iteration_ms_without_teacher": [base_before[0], base_after[0]],
           "iteration_ms_phase22_windowed": no_teacher_ms, "peak_gib": peak,
           "profiled_wall_ms": prof["wall_ms"],
           "profiled_busy_ms": prof["busy_ms"], "idle_share": idle,
           "profiled_busy_ms_without_teacher": [base_before[1],
                                                base_after[1]],
           "teacher_device_ms": prof["teacher_ms"], "teacher_share": share,
           "teacher_alone_device_ms": alone_ms,
           "teacher_host_ms_per_frame": host_ms,
           "teacher_alone_top_kernels": alone_top,
           "top_kernels": prof["top_kernels"], "terms": terms,
           "counts": {k: sum(c[k] for _, c in steps) for k in per_frame}}
    say(tag, f"{ENTRY_WINDOWED_YAML} learns from checkpoint_1.pth "
        f"({t_cfg.get('ENCODER_TYPE', 'deformable')}): {len(steps)} steps "
        f"T=2 in {wall:.1f} s; per step "
        + ", ".join(f"{k} {n} x T" for k, n in per_frame.items())
        + f" launches ok (msda_fwd {t_frame} x T above phase 22's windowed "
        f"run); distill terms every step finite and > 0: "
        + "; ".join(", ".join(f"{k[8:]} {v:.4g}" for k, v in rec.items())
                    for rec in terms)
        + f"; the teacher untouched, frozen and outside the optimizer and the "
        f"checkpoint; {it_ms:.1f} ms an iteration (steps 1-2; the same run "
        f"without a teacher, before and after: {base_before[0]:.1f}, "
        f"{base_after[0]:.1f}; phase 22's, its first on these canvases: "
        f"{no_teacher_ms:.1f}); the host's dispatch of a teacher forward "
        f"{host_ms:.1f} ms (steps 1-2); peak {peak:.2f} GiB")
    say(tag, f"profiled step 3: host wall {prof['wall_ms']:.1f} ms, device "
        f"busy {prof['busy_ms']:.1f} ms (without a teacher "
        f"{base_before[1]:.1f}, {base_after[1]:.1f}), idle share "
        f"{idle:.3f}; the teacher's forwards {prof['teacher_ms']:.2f} ms of "
        f"device time, {share:.1%} of busy; one teacher forward alone, warm, "
        f"on the last frame it saw: {alone_ms:.2f} ms of device time")
    for k, v in sorted(prof["families"].items(), key=lambda kv: -kv[1]):
        say(tag, f"  {k}: {v:.2f} ms ({v / prof['busy_ms']:.1%} of busy)")
    for name, ms, n in prof["top_kernels"]:
        say(tag, f"  step kernel {ms:.2f} ms x{n}: {name[:150]}")
    for name, ms in alone_top:
        say(tag, f"  teacher-alone kernel {ms:.3f} ms: {name[:150]}")
    return res


# ---------------------------------------------------------------- serving
# phase 25: frames a served artifact steps, and the timed ones (3 on)
SERVING_FRAMES = 8
SERVING_PROFILED = 3
# the artifact's rows against the live step's: the exported graph holds
# the eager ATen ops (no decompositions) and K1 and K2 as one op node each,
# which launch the same kernels on the same inputs, so the rows are
# expected bit for bit; the box and score columns are held to this (one
# float32 ulp at 1), ids, labels and alive to equality
SERVING_ATOL = 1.2e-7
SERVING_TIMEOUT = 600
SERVING_BANNED = ("jax", "jaxlib", "flax", "memotr_tpu",
                  "memotr_tpu_torch.models", "memotr_tpu_torch.engine")
DEMO_FRAMES = 5
VISUALIZE_FRAMES = 3


def serve_artifact(art: str) -> None:
    """Phase 25's serving process: loads ``art`` through
    ``memotr_tpu_torch.serving`` alone, steps ``frames.npz`` (counting K1's
    and K2's launches frame by frame, from this process's counters), checks
    that no model, engine or JAX module came in and replays frame 0 after
    ``reset()``.  Only then does it import the model code, build the live
    model from ``live.pt`` and ``config.json``, and time the live step and
    the runtime in turns on the same frames (live, runtime, runtime,
    live); last, it profiles SERVING_PROFILED runtime frames (after the
    turns, which a profiler session before them could slow).  Prints one
    JSON line; the runtime's rows go to ``rows.npy``, the live step's to
    ``live_rows.npy``."""
    from memotr_tpu_torch.ops import msda_cuda, window_attn_cuda
    from memotr_tpu_torch.serving import ServingRuntime
    from memotr_tpu_torch.utils.profiling import (StepTimer,
                                                  device_memory_stats, trace)
    t0 = time.perf_counter()
    rt = ServingRuntime.load(art)
    load_s = time.perf_counter() - t0
    with np.load(os.path.join(art, "frames.npz")) as z:
        images, masks = z["images"], z["masks"]
    rows, counts, ms = [], [], []
    timer = StepTimer(skip_first=2)
    for image, mask in zip(images, masks):
        k1, k2 = msda_cuda.launches, window_attn_cuda.launches
        t0 = time.perf_counter()
        with timer:
            rows.append(rt.step(image, mask))
        ms.append(1e3 * (time.perf_counter() - t0))
        counts.append([msda_cuda.launches - k1,
                       window_attn_cuda.launches - k2])
    banned = sorted(m for m in sys.modules
                    if m.split(".")[0] in SERVING_BANNED
                    or m.startswith(SERVING_BANNED[-2:]))
    rt.reset()
    replay = rt.step(images[0], masks[0])
    memory = device_memory_stats(rt.device)

    from memotr_tpu_torch.models.memotr import build_model
    with open(os.path.join(art, "config.json")) as f:
        config = json.load(f)
    model = build_model(config)
    model.load_state_dict(torch.load(os.path.join(art, "live.pt"),
                                     weights_only=True))
    model.to(rt.device).eval()
    frames = [{"image": i, "mask": m} for i, m in zip(images, masks)]
    turns = {"live": [], "runtime": []}
    for kind in ("live", "runtime", "runtime", "live"):
        if kind == "live":
            got, pass_ms = live_rows(model, config, frames, rt.device)
            if not turns["live"]:
                np.save(os.path.join(art, "live_rows.npy"), got)
        else:
            rt.reset()
            pass_ms = []
            for image, mask in zip(images, masks):
                t0 = time.perf_counter()
                rt.step(image, mask)
                pass_ms.append(1e3 * (time.perf_counter() - t0))
        turns[kind].append(float(np.mean(pass_ms[2:])))
    rt.reset()
    for image, mask in zip(images[:3], masks[:3]):
        rt.step(image, mask)
    with trace(os.path.join(art, "trace")) as prof:
        for image, mask in zip(images[3:3 + SERVING_PROFILED],
                               masks[3:3 + SERVING_PROFILED]):
            rt.step(image, mask)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if is_kernel(e)) / 1e3 / SERVING_PROFILED
    np.save(os.path.join(art, "rows.npy"), np.stack(rows))
    print(json.dumps({
        "counts": counts, "ms": ms, "mean_ms": 1e3 * timer.mean,
        "banned": banned, "replay_equal": bool(np.array_equal(replay,
                                                                 rows[0])),
        "load_s": load_s, "busy_ms": busy, "memory": memory,
        "turns": turns}), flush=True)


def live_rows(model, config, frames, device):
    """The live step on ``frames``: normalize, ``eval_frame_step`` (no eval
    cache, as the export), ``pack_results``, one host fetch a frame ->
    (rows (n, S, 9), host ms a frame)."""
    from memotr_tpu_torch.engine.submit import normalize_uint8, pack_results
    from memotr_tpu_torch.models.frame_step import eval_frame_step
    from memotr_tpu_torch.structures.track_state import TrackState
    state = TrackState.empty(1, config["TRACK_SLOTS"], model.hidden_dim,
                             model.num_classes, use_dab=model.use_dab,
                             device=device)
    rows, ms = [], []
    with torch.inference_mode():
        for fr in frames:
            t0 = time.perf_counter()
            images = torch.from_numpy(fr["image"])[None].to(device)
            mask = torch.from_numpy(fr["mask"])[None].to(device)
            results, state = eval_frame_step(
                model, normalize_uint8(images), mask, state,
                config["DET_SCORE_THRESH"], config["TRACK_SCORE_THRESH"],
                config["MISS_TOLERANCE"])
            rows.append(pack_results(results).cpu().numpy()[0])
            ms.append(1e3 * (time.perf_counter() - t0))
    return np.stack(rows), ms


def serve_in_subprocess(art: str) -> dict:
    """``serve_artifact`` in a fresh interpreter (which reaches the card
    anew); its JSON line."""
    code = ("import sys; sys.path.insert(0, '.'); import chip_smoke; "
            f"chip_smoke.serve_artifact({art!r})")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=SERVING_TIMEOUT,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise RuntimeError(f"serving process failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_serving_model(device, tmp, name, config, per_frame):
    """Export ``config`` (``random_weights_``, 800x1536, bf16) on the card,
    serve it in a fresh process and hold its rows against the live
    step's."""
    from memotr_tpu_torch.models.memotr import build_model
    from memotr_tpu_torch.serving import export_streaming
    tag = "25 serving"
    state_dict = random_weights_(build_model(config)).state_dict()
    art = os.path.join(tmp, f"artifact_{name}")
    t0 = time.perf_counter()
    export_streaming(config, state_dict, art, canvas_hw=CANVAS,
                     device=device)
    export_s = time.perf_counter() - t0
    size = os.path.getsize(os.path.join(art, "step.pt2"))
    say(tag, f"{name}: export_streaming on the card in {export_s:.1f} s; "
        f"step.pt2 {size / 2 ** 20:.1f} MiB")
    frames = list(synthetic_frames(SERVING_FRAMES, seed=3))
    np.savez(os.path.join(art, "frames.npz"),
             images=np.stack([f["image"] for f in frames]),
             masks=np.stack([f["mask"] for f in frames]))
    torch.save(state_dict, os.path.join(art, "live.pt"))
    with open(os.path.join(art, "config.json"), "w") as f:
        json.dump(config, f)
    del state_dict
    served = serve_in_subprocess(art)
    assert not served["banned"], f"the serving process imported " \
        f"{served['banned']}"
    k1, k2 = per_frame["msda_fwd"], per_frame["window_attn_fwd"]
    assert all(c == [k1, k2] for c in served["counts"]), served["counts"]
    say(tag, f"{name}: a fresh process that imports only "
        f"memotr_tpu_torch.serving (no models, engine or JAX module) "
        f"loaded it in {served['load_s']:.1f} s and stepped "
        f"{SERVING_FRAMES} frames; K1, K2 launches a frame counted there: "
        f"{served['counts'][0]} ok")
    got = np.load(os.path.join(art, "rows.npy"))
    want = np.load(os.path.join(art, "live_rows.npy"))
    assert got.shape == want.shape == (SERVING_FRAMES, config["TRACK_SLOTS"],
                                       9), (got.shape, want.shape)
    assert np.isfinite(got).all()
    exact = [0, 1, 7, 8]                     # id, label, alive, overflow
    assert np.array_equal(got[..., exact], want[..., exact]), \
        f"{name}: ids, labels or alive differ from the live step's"
    err = float(np.abs(got[..., 2:7] - want[..., 2:7]).max())
    assert err <= SERVING_ATOL, f"{name}: boxes/scores differ by {err}"
    alive = got[..., 7].sum(axis=1).astype(int).tolist()
    assert max(alive) > 0, f"{name}: no live track in {alive}"
    assert served["replay_equal"], f"{name}: reset() did not replay frame 0"
    bit = bool(np.array_equal(got, want))
    say(tag, f"{name}: rows == the live eval_frame_step + pack_results on "
        f"the same frames (run in the serving process after its import "
        f"check): ids, labels, alive equal, boxes and scores max "
        f"|diff| {err:.3g} (tolerance {SERVING_ATOL}); bit for bit: {bit}; "
        f"live slots a frame {alive}; reset() replays frame 0 bit for bit ok")
    turns = served["turns"]
    run_ms, live_ms = np.mean(turns["runtime"]), np.mean(turns["live"])
    idle = 1 - served["busy_ms"] / served["mean_ms"]
    say(tag, f"{name}: ms a frame, frames 3-{SERVING_FRAMES} (upload, step, "
        f"one fetch), in turns in the serving process (live, runtime, "
        f"runtime, live): ServingRuntime.step {turns['runtime']} mean "
        f"{run_ms:.2f}; live step {turns['live']} mean {live_ms:.2f}; "
        f"ratio {run_ms / live_ms:.3f}; the first pass of the runtime, "
        f"frames 3-{SERVING_FRAMES}: mean {served['mean_ms']:.2f}; runtime "
        f"device busy "
        f"{served['busy_ms']:.2f} ms a frame over {SERVING_PROFILED} profiled "
        f"frames, idle share {idle:.3f}; peak "
        f"{served['memory'].get('peak_bytes_in_use', 0) / 2 ** 30:.2f} GiB")
    return {"export_s": export_s, "pt2_mib": size / 2 ** 20,
            "load_s": served["load_s"], "runtime_ms": float(run_ms),
            "live_ms": float(live_ms), "turns": turns,
            "idle": idle, "busy_ms": served["busy_ms"], "max_abs_err": err,
            "bit_equal": bit, "per_frame": served["counts"][0],
            "launches": {"msda_fwd": sum(c[0] for c in served["counts"]),
                         "window_attn_fwd": sum(c[1]
                                                for c in served["counts"])}}


def write_video(path: str, n_frames: int) -> None:
    """``n_frames`` synthetic frames at ORI_HW, XVID, for the demo."""
    import cv2
    h, w = ORI_HW
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"XVID"), 25,
                             (w, h))
    for fr in synthetic_frames(n_frames, seed=4):
        img = cv2.resize(fr["image"][:RESIZED[0], :RESIZED[1]], (w, h))
        writer.write(img[:, :, ::-1].copy())
    writer.release()


def count_video_frames(path: str) -> int:
    import cv2
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def serving_run(tmp: str) -> dict:
    """A training run's directory for phase 25 alone, in place of phase
    22's: ENTRY_YAML as ``train/config.yaml`` and a ``checkpoint_1.pth``
    of ``random_weights_``; the paths as phase 22 returns them."""
    from memotr_tpu_torch.checkpoint.files import save_checkpoint
    from memotr_tpu_torch.config import dict_to_yaml, yaml_to_dict
    from memotr_tpu_torch.models.memotr import build_model
    run = os.path.join(tmp, "run")
    os.makedirs(os.path.join(run, "train"))
    cfg = yaml_to_dict(ENTRY_YAML)
    yaml_path = os.path.join(tmp, "config.yaml")
    dict_to_yaml(cfg, yaml_path)
    dict_to_yaml(cfg, os.path.join(run, "train", "config.yaml"))
    save_checkpoint(os.path.join(run, "checkpoint_1.pth"),
                    random_weights_(build_model(cfg)))
    return {"tmp": tmp, "run": run, "yaml": yaml_path}


def phase_serving(device, paths):
    """Phase 25: the serving export of the deformable and the windowed
    models (``phase_serving_model``), then the tools on phase 22's run:
    ``tools.export_serving`` of checkpoint_1.pth (one frame stepped),
    ``VISUALIZE`` on a short submit (the dumps' files and keys) and
    ``tools.demo`` on a synthetic video (its frames counted).  Returns the
    numbers for the result line."""
    from memotr_tpu_torch.config import yaml_to_dict
    from memotr_tpu_torch.serving import ServingRuntime
    from memotr_tpu_torch.structures.track_state import SLOT_FIELDS
    from memotr_tpu_torch.tools import demo, export_serving
    tag = "25 serving"
    tmp = os.path.join(paths["tmp"], "serving")
    res = {}
    n_levels = WINDOWED_CONFIG["NUM_FEATURE_LEVELS"]
    for name, config, per_frame in (
            ("deformable", CONFIG,
             {"msda_fwd": CONFIG["NUM_ENC_LAYERS"] + CONFIG["NUM_DEC_LAYERS"],
              "window_attn_fwd": 0}),
            ("windowed", WINDOWED_CONFIG,
             {"msda_fwd": WINDOWED_CONFIG["NUM_DEC_LAYERS"],
              "window_attn_fwd": WINDOWED_CONFIG["NUM_ENC_LAYERS"]
              * n_levels})):
        t0 = time.perf_counter()
        res[name] = phase_serving_model(device, tmp, name, config, per_frame)
        say(tag, f"{name} done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    art = os.path.join(tmp, "artifact_entry")
    export_serving.main(["--submit-dir", paths["run"], "--submit-model",
                         "checkpoint_1", "--out", art, "--device",
                         str(device)])
    rt = ServingRuntime.load(art)
    fr = next(synthetic_frames(1, seed=5))
    reset_counts()
    rows = rt.step(fr["image"], fr["mask"])
    counts = read_counts()
    cfg = yaml_to_dict(paths["yaml"])
    assert rows.shape == (cfg["TRACK_SLOTS"], 9) and np.isfinite(rows).all()
    assert counts["msda_fwd"] == cfg["NUM_ENC_LAYERS"] \
        + cfg["NUM_DEC_LAYERS"], counts
    say(tag, f"python -m memotr_tpu_torch.tools.export_serving on phase 22's "
        f"checkpoint_1.pth -> {rt.manifest['canvas_hw']} artifact; one "
        f"frame stepped: rows {rows.shape} finite, {counts['msda_fwd']} K1 "
        f"launches ok ({time.perf_counter() - t0:.1f} s)")
    del rt

    t0 = time.perf_counter()
    from memotr_tpu_torch.models.memotr import build_model
    model = random_weights_(build_model(CONFIG)).to(device).eval()
    vis_cfg = dict(CONFIG, VISUALIZE=True)
    out_dir = os.path.join(tmp, "visualize_run")
    sub = checked_submitter("DanceTrack", synthetic_frames(VISUALIZE_FRAMES),
                            "synthetic", out_dir, model, vis_cfg, device)
    assert not sub.pipelined, "VISUALIZE must take the sync loop"
    sub.run()
    dump_dir = os.path.join(out_dir, "visualize", "synthetic")
    files = sorted(os.listdir(dump_dir))
    want_files = [f"frame_{i:06d}.npz" for i in range(VISUALIZE_FRAMES)]
    assert files == want_files, files
    with np.load(os.path.join(dump_dir, files[-1])) as z:
        keys = set(z.files)
        want_keys = {f"results.{k}" for k in ("ids", "labels", "boxes",
                                             "scores", "mask")} | {
            f"state.{f}" for f in SLOT_FIELDS + ("next_id",)}
        assert keys == want_keys, sorted(keys ^ want_keys)
        assert np.array_equal(z["results.ids"], z["state.ids"])
    say(tag, f"VISUALIZE: a {VISUALIZE_FRAMES}-frame submit took the sync "
        f"loop and dumped {files} with the JAX package's {len(keys)} keys "
        f"ok ({time.perf_counter() - t0:.1f} s)")
    del model, sub

    t0 = time.perf_counter()
    video = os.path.join(tmp, "demo_in.avi")
    write_video(video, DEMO_FRAMES)
    demo_out = os.path.join(tmp, "demo_out.avi")
    reset_counts()
    n = demo.main(["--config", paths["yaml"], "--checkpoint",
                   os.path.join(paths["run"], "checkpoint_1.pth"), "--video",
                   video, "--out", demo_out, "--device", str(device)])
    counts = read_counts()
    n_out = count_video_frames(demo_out)
    assert n == n_out == DEMO_FRAMES, (n, n_out)
    assert counts["msda_fwd"] == DEMO_FRAMES * (cfg["NUM_ENC_LAYERS"]
                                                + cfg["NUM_DEC_LAYERS"])
    say(tag, f"python -m memotr_tpu_torch.tools.demo: {DEMO_FRAMES} frames "
        f"of a {ORI_HW[1]}x{ORI_HW[0]} XVID video in, {n_out} annotated "
        f"frames out, {counts['msda_fwd']} K1 launches ok "
        f"({time.perf_counter() - t0:.1f} s)")
    res["launches_demo"] = counts["msda_fwd"]
    return res


# ---------------------------------------------------------------- campaign
CAMPAIGN_VARIANTS = ("deformable_w256", "windowed_w256_transplant",
                     "hybrid_w256_transplant")
# the phase's proxy-v3 world: (sequences, frames) a split; 8 val sequences,
# so the evaluation streams 8 lanes (SUBMIT_BATCH 8 of base_config)
CAMPAIGN_WORLD = {"train": (2, 24), "val": (8, 16)}
CAMPAIGN_EPOCHS = 1
CAMPAIGN_SEED = 42
CAMPAIGN_CANVAS = (256, 320)  # tools/flagship_eval.py H, W: frames fill it
CAMPAIGN_ENC_SHAPES = ((32, 40), (16, 20), (8, 10), (4, 5))  # 256x320 / 8..64
CAMPAIGN_DEC_LQ = 64          # NUM_DET_QUERIES 40 + TRACK_SLOTS 24
CAMPAIGN_LANES = 8
CAMPAIGN_PROBE_STEPS = 6      # timed steps at each T after a run, 2 warm-up
CAMPAIGN_FULL_EPOCHS = 10     # the v3 protocol the wall is extrapolated to


def campaign_per_frame(cfg: dict) -> dict:
    """K1's and K2's forward launches a frame of a campaign model (the
    backward's are the same in training): the windowed encoder runs K2 at
    every level of every layer, the hybrid at level 0 and K1 at the
    others, the deformable K1; the decoder K1 a layer."""
    enc, dec = cfg["NUM_ENC_LAYERS"], cfg["NUM_DEC_LAYERS"]
    kind = cfg["ENCODER_TYPE"]
    k2 = {"deformable": 0, "windowed": enc * cfg["NUM_FEATURE_LEVELS"],
          "hybrid": enc}[kind]
    return {"msda_fwd": dec + (0 if kind == "windowed" else enc),
            "window_attn_fwd": k2}


def phase_campaign_kernels(device) -> dict:
    """K1 and K2 at the campaign's shapes (the 256x320 canvas's 1,700-token
    pyramid, decoder Lq 64, K2's window and grid attention at every
    level), float32: forward at B=8 (the evaluation's lanes) through the
    ops, backward at B=1 (training), each against the plain version at
    the float32 tolerances of phases 3, 4, 11 and 14.  Returns each
    kernel's largest error."""
    from memotr_tpu_torch.ops import msda_cuda
    from memotr_tpu_torch.ops import window_attn_cuda as wac
    from memotr_tpu_torch.ops.msda import ms_deform_attn
    from memotr_tpu_torch.ops.msda import ms_deform_attn_torch as plain
    from memotr_tpu_torch.ops.window_attn import (window_attention,
                                                  window_attention_torch)
    shapes = CAMPAIGN_ENC_SHAPES
    errs = dict.fromkeys(("msda_fwd", "msda_bwd", "window_attn_fwd",
                          "window_attn_bwd"), 0.0)
    gen = torch.Generator(device).manual_seed(26)
    tag = "26 campaign"
    for name, lq in (("encoder", sum(h * w for h, w in shapes)),
                     ("decoder", CAMPAIGN_DEC_LQ)):
        v, loc, aw = msda_inputs(26, CAMPAIGN_LANES, shapes, 8, 32, 4, lq,
                                 torch.float32, device)
        with torch.inference_mode():
            before = msda_cuda.launches
            out = ms_deform_attn(v, shapes, loc, aw)
            assert msda_cuda.launches == before + 1, "no K1 launch"
            ref = plain(v, shapes, loc, aw)
        torch.testing.assert_close(out, ref, **F32_TOL)
        err = (out - ref).abs().max().item()
        errs["msda_fwd"] = max(errs["msda_fwd"], err)
        say(tag, f"K1 {name} B={CAMPAIGN_LANES} Lq={lq} f32: max_abs_err "
            f"{err:.3e} (atol {F32_TOL['atol']} rtol {F32_TOL['rtol']}) ok")
        v, loc, aw = msda_inputs(27, 1, shapes, 8, 32, 4, lq, torch.float32,
                                 device)
        g = torch.randn((1, lq, 256), generator=gen, device=device)
        before = msda_cuda.bwd_launches
        got = msda_cuda.msda_backward(v, shapes, loc, aw, g)
        assert msda_cuda.bwd_launches == before + 1, "no K1 backward launch"
        want = plain_msda_grads(v, shapes, loc, aw, g)
        parts = []
        for gname, x, y in zip(("value", "loc", "aw"), got, want):
            assert torch.isfinite(x).all(), (name, gname)
            diff = (x - y).abs().max().item()
            assert diff <= K1B_REL * y.abs().max().item() + 1e-7, \
                (name, gname, diff)
            errs["msda_bwd"] = max(errs["msda_bwd"], diff)
            parts.append(f"grad_{gname} {diff:.3e}")
        say(tag, f"K1 backward {name} B=1 Lq={lq} f32: max_abs_err "
            + ", ".join(parts) + f" (each within {K1B_REL} of its largest "
            "element) ok")
    geometry = (shapes, CAMPAIGN_CANVAS, CAMPAIGN_CANVAS)
    for name in ("window_l0", "window_l1", "window_l2", "window_l3",
                 "grid_l0", "grid_l1", "grid_l2", "grid_l3"):
        args, geo = k2_case(name, torch.float32, device, seed=26,
                            geometry=geometry, batch=CAMPAIGN_LANES)
        with torch.inference_mode():
            before = wac.launches
            out = window_attention(*args, *geo)
            assert wac.launches == before + 1, "no K2 launch"
            ref = window_attention_torch(*args, *geo)
        torch.testing.assert_close(out, ref, **K2_F32_TOL)
        err = (out - ref).abs().max().item()
        errs["window_attn_fwd"] = max(errs["window_attn_fwd"], err)
        args, geo = k2_case(name, torch.float32, device, seed=27,
                            geometry=geometry, batch=1)
        g = torch.randn(args[0].shape, generator=gen, device=device)
        f0, b0 = wac.launches, wac.bwd_launches
        got = k2_grads(window_attention, k2_leaves(args), args[2], geo, g)
        assert (wac.launches, wac.bwd_launches) == (f0 + 1, b0 + 1), \
            "no K2 backward launch"
        want = k2_grads(window_attention_torch, k2_leaves(args), args[2],
                        geo, g)
        worst = 0.0
        for a, r in zip(got, want):
            assert torch.isfinite(a).all(), name
            diff = (a - r).abs().max().item()
            assert diff <= K2B_F32_REL * r.abs().max().item() + 1e-7, \
                (name, diff)
            worst = max(worst, diff)
        errs["window_attn_bwd"] = max(errs["window_attn_bwd"], worst)
        say(tag, f"K2 {name} L={geo[1] * geo[2]} f32: forward B="
            f"{CAMPAIGN_LANES} x {tuple(out.shape)} max_abs_err {err:.3e} "
            f"(atol {K2_F32_TOL['atol']} rtol {K2_F32_TOL['rtol']}); "
            f"backward B=1 largest gradient error {worst:.3e} (each within "
            f"{K2B_F32_REL} of its largest element) ok")
    return errs


def campaign_probe(run, cfg, device, profile: bool) -> dict:
    """Host ms of a training iteration of a finished campaign run at T=2
    and T=3: ``CAMPAIGN_PROBE_STEPS`` more steps of its trainer at each
    clip length (the curriculum's epochs 0 and ``SAMPLE_STEPS[0]``), each
    from a collated batch to the logs on the host, as ``train``'s loop
    times them; the median after 2 warm-up steps.  With ``profile``, one
    more T=2 step under torch.profiler: wall, device busy and idle
    share."""
    from torch.profiler import ProfilerActivity, profile as profiler

    from memotr_tpu_torch.data import build_dataloader, build_dataset
    from memotr_tpu_torch.engine.train import _host_logs
    dataset = build_dataset(cfg, split="train")
    loader = build_dataloader(dataset, cfg, shuffle=True)
    out = {}
    for epoch in (0, cfg["SAMPLE_STEPS"][0]):
        loader.set_epoch(epoch)
        times, prof = [], None
        for i, batch in enumerate(loader):
            batch.pop("gt_dropped", None)
            t = batch["images"].shape[1]
            last = i == CAMPAIGN_PROBE_STEPS
            if last and not (profile and epoch == 0):
                break
            with (profiler(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
                  if last else contextlib.nullcontext()) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _host_logs(run.trainer.step(batch, epoch), device)
                times.append((time.perf_counter() - t0) * 1e3)
            if last:
                break
        out[f"T{t}"] = float(np.median(times[2:CAMPAIGN_PROBE_STEPS]))
        if prof is not None:
            busy = sum(e.self_device_time_total / 1e3
                       for e in prof.key_averages() if is_kernel(e))
            out["profiled"] = {"T": t, "wall_ms": times[-1],
                               "busy_ms": busy,
                               "idle": 1 - busy / times[-1]}
    return out


def campaign_extrapolate(probe: dict, run, eval_s: float) -> dict:
    """The wall of one full v3 run (``CAMPAIGN_FULL_EPOCHS`` epochs of
    ``N_TRAIN_SEQS`` x ``N_FRAMES_V3`` frames, scored on ``N_VAL_SEQS`` x
    ``N_FRAMES_V3``), from this run's numbers: each epoch's clip starts
    (``flagship_eval.epoch_iterations``) at the probe's ms an iteration of
    its T, the phase's
    per-epoch overhead (its epoch's wall less its iterations: checkpoint,
    loader start) every epoch, and the phase's evaluation scaled by the
    frames a lane."""
    from memotr_tpu_torch.tools import flagship_eval as fe
    iters = {}
    for t, n in fe.epoch_iterations(CAMPAIGN_FULL_EPOCHS):
        iters[t] = iters.get(t, 0) + n
    train_s = sum(n * probe[f"T{t}"] / 1e3 for t, n in iters.items())
    overhead = max(run.wall_s - sum(run.step_seconds) - sum(run.wait_seconds),
                   0.0)
    eval_full = eval_s * fe.N_FRAMES_V3 / CAMPAIGN_WORLD["val"][1]
    return {"iterations": {f"T{t}": n for t, n in iters.items()},
            "train_s": train_s, "overhead_s": CAMPAIGN_FULL_EPOCHS * overhead,
            "eval_s": eval_full,
            "wall_s": train_s + CAMPAIGN_FULL_EPOCHS * overhead + eval_full}


def phase_campaign(device, tmp=None) -> dict:
    """Phase 26: the port's ``tools/flagship_eval`` on a small proxy-v3
    world (``CAMPAIGN_WORLD``) at its configs (``base_config``: HIDDEN_DIM
    256 for these variants, float32, 256x320): the deformable teacher, then
    the windowed and hybrid transplants from its last checkpoint, one
    epoch each, each scored on the 8 val sequences as 8 lanes; then
    ``quality_report`` and ``scalars_report`` over the workdir.  Counts
    each kernel's launches a run (set to 0 just before it, read just
    after) and a step, and returns the numbers of the JSON lines."""
    import memotr_tpu_torch.engine.train as train_module
    from memotr_tpu_torch.engine.trainer import Trainer
    from memotr_tpu_torch.tools import flagship_eval as fe

    tag = "26 campaign"
    tmp = tmp or tempfile.mkdtemp()
    workdir = os.path.join(tmp, "campaign")
    root = os.path.join(workdir, "data")
    t0 = time.perf_counter()
    for split, seed in (("train", 3), ("val", 99)):
        n_seqs, n_frames = CAMPAIGN_WORLD[split]
        fe.make_synvalue_v3(root, split, n_seqs, n_frames, seed=seed)
    with open(os.path.join(root, ".proxy_v3"), "w") as f:
        f.write("proxy v3\n")
    os.environ["PROXY_VERSION"] = "3"
    assert fe.ensure_data(workdir) == root
    say(tag, f"proxy-v3 world {CAMPAIGN_WORLD} at {fe.H}x{fe.W} in "
        f"{time.perf_counter() - t0:.1f} s")

    orig_train, orig_step = train_module.train, Trainer.step
    runs, steps, walls = [], [], []

    def captured_train(config, device="cuda"):
        t_start = time.perf_counter()
        run = orig_train(config, device)
        torch.cuda.synchronize()
        run.wall_s = time.perf_counter() - t_start
        runs.append((config, run))
        walls.append(time.perf_counter())
        return run

    def counted_step(self, batch, epoch=0):
        before = read_counts()
        logs = orig_step(self, batch, epoch)
        torch.cuda.synchronize()
        after = read_counts()
        steps.append((batch["images"].shape[1],
                      {k: after[k] - before[k] for k in after}))
        return logs

    results = {}
    train_module.train, Trainer.step = captured_train, counted_step
    try:
        for name in CAMPAIGN_VARIANTS:
            del steps[:]
            torch.cuda.reset_peak_memory_stats(device)
            reset_counts()
            t_run = time.perf_counter()
            metrics = fe.run_variant(root, workdir, name, CAMPAIGN_EPOCHS,
                                     CAMPAIGN_SEED, str(device))
            torch.cuda.synchronize()
            counts = read_counts()
            wall = time.perf_counter() - t_run
            cfg, run = runs[-1]
            eval_s = time.perf_counter() - walls[-1]
            per_frame = campaign_per_frame(cfg)
            assert steps, f"{name}: no training step"
            for t, c in steps:
                for k, n in per_frame.items():
                    bwd = k.replace("_fwd", "_bwd")
                    assert c[k] == n * t and c[bwd] == n * t, \
                        f"{tag} {name}: {c} a T={t} step, expected {n} x {t}"
            n_steps, n_frames = len(steps), sum(t for t, _ in steps)
            eval_steps = CAMPAIGN_WORLD["val"][1]
            for k, n in per_frame.items():
                want = n * (n_frames + eval_steps)
                assert counts[k] == want, (name, k, counts[k], want)
                assert counts[k.replace("_fwd", "_bwd")] == n * n_frames
            mfile = os.path.join(fe.run_dir(workdir, name, CAMPAIGN_SEED),
                                 "val", f"checkpoint_{CAMPAIGN_EPOCHS - 1}"
                                 "_metrics.json")
            with open(mfile) as f:
                scored = json.load(f)
            assert all(np.isfinite(scored[k]) for k in EVAL_SUMMARY), scored
            if name != CAMPAIGN_VARIANTS[0]:
                stats = run.pretrain
                teacher = torch.load(cfg["PRETRAINED_MODEL"],
                                     map_location="cpu", weights_only=True)
                enc = sum(train_module._units(k) for k in teacher["model"]
                          if k.startswith("transformer.encoder."))
                rest = sum(train_module._units(k) for k in teacher["model"]
                           if not k.startswith("transformer.encoder.")
                           and not train_module._HEAD_ALIAS.match(k))
                assert stats == {"loaded": rest, "shape_mismatch": 0,
                                 "encoder_skipped": enc}, (name, stats)
                say(tag, f"{name}: transplant of {cfg['PRETRAINED_MODEL']}: "
                    f"{stats['loaded']} tensors loaded (every one outside "
                    f"the encoder), {stats['encoder_skipped']} encoder "
                    f"leaves skipped, none shape-mismatched")
            probe = campaign_probe(run, cfg, device,
                                   profile=name == CAMPAIGN_VARIANTS[1])
            steady = 1e3 * (np.asarray(run.step_seconds)
                            + np.asarray(run.wait_seconds))[2:]
            full = campaign_extrapolate(probe, run, eval_s)
            results[name] = {
                "metrics": metrics, "launches": counts,
                "per_frame": per_frame, "train_steps": n_steps,
                "eval_lanes": CAMPAIGN_LANES, "eval_steps": eval_steps,
                "run_s": wall, "eval_s": eval_s,
                "iteration_ms_T2_in_train": float(np.median(steady)),
                "probe_ms": probe, "peak_gib":
                    torch.cuda.max_memory_allocated(device) / 2 ** 30,
                "full_run": full}
            say(tag, f"{name}: {n_steps} steps at T=2 and 8-lane "
                f"evaluation ({eval_steps} steps) in {wall:.1f} s (eval "
                f"{eval_s:.1f} s); launches {counts}; HOTA "
                f"{scored['HOTA']:.3f} DetA {scored['DetA']:.3f} AssA "
                f"{scored['AssA']:.3f}; host ms an iteration: "
                f"{np.median(steady):.1f} at T=2 in train(), probe T=2 "
                f"{probe['T2']:.1f}, T=3 {probe['T3']:.1f}; peak "
                f"{results[name]['peak_gib']:.2f} GiB")
            if "profiled" in probe:
                pr = probe["profiled"]
                say(tag, f"{name}: a profiled T={pr['T']} iteration: wall "
                    f"{pr['wall_ms']:.1f} ms, device busy "
                    f"{pr['busy_ms']:.1f} ms, idle share {pr['idle']:.3f}")
            say(tag, f"{name}: extrapolated wall of one full v3 run "
                f"({CAMPAIGN_FULL_EPOCHS} epochs, {full['iterations']} "
                f"iterations, 8-lane evaluation of {fe.N_FRAMES_V3} frames): "
                f"{full['wall_s'] / 60:.1f} min (training "
                f"{full['train_s'] / 60:.1f}, per-epoch overhead "
                f"{full['overhead_s'] / 60:.1f}, evaluation "
                f"{full['eval_s'] / 60:.1f})")
            del run
    finally:
        train_module.train, Trainer.step = orig_train, orig_step
        runs.clear()

    def tool(*argv):
        out = subprocess.run([sys.executable, "-m", *argv], check=True,
                             capture_output=True, text=True,
                             timeout=120).stdout
        print(out, end="", flush=True)
        return out

    tool("memotr_tpu_torch.tools.quality_report", workdir,
         os.path.join(workdir, "quality.json"), "--md")
    with open(os.path.join(workdir, "quality.json")) as f:
        agg = json.load(f)
    assert set(agg) == set(CAMPAIGN_VARIANTS), agg
    assert all(np.isfinite(a["HOTA"]["mean"]) for a in agg.values()), agg
    for name in CAMPAIGN_VARIANTS:
        out = tool("memotr_tpu_torch.tools.scalars_report", os.path.join(
            fe.run_dir(workdir, name, CAMPAIGN_SEED), "train",
            "scalars.jsonl"), "loss")
        assert "total_loss" in out, (name, out)
    return results


# ------------------------------------------- training options (27-28)
# phase 27's deformable step: the clip length of the bench's T=5 step
CKPT_T = 5
# phase 28: the dropout rate of the option's check (every site live)
OPTIONS_DROPOUT = 0.1


def train_once(config, state_dict, batch, device, seed=0):
    """One ``Trainer.step`` of a fresh ``config`` model holding
    ``state_dict``: the launches (set to 0 just before the step, read just
    after), the step's host ms (synchronized) and its peak memory (GiB:
    ``max_memory_allocated`` over the step less what was allocated before
    the model was built, after a garbage collection, so that tensors left
    by earlier phases and trainers do not count; the model's weights, its
    gradients and the optimizer's state do).  Returns (trainer, logs,
    counts, ms, peak)."""
    import gc

    from memotr_tpu_torch.engine.trainer import Trainer
    from memotr_tpu_torch.models.memotr import build_model
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    model = build_model(config)
    model.load_state_dict(state_dict)
    trainer = Trainer(model, config, device, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    logs = trainer.step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    peak = (torch.cuda.max_memory_allocated(device) - base) / 2 ** 30
    for k, v in logs.items():
        if isinstance(v, torch.Tensor):
            assert torch.isfinite(v).all(), (k, v)
    return trainer, logs, counts, ms, peak


def grad_step_once(config, state_dict, batch, device):
    """The float32 check of phases 13 and 28: one unclipped ``grad_step``
    (TF32 off) of a fresh ``config`` model holding ``state_dict``; returns
    (model, logs, counts)."""
    from memotr_tpu_torch.engine.trainer import Trainer
    from memotr_tpu_torch.models.memotr import build_model
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(config)
    model.load_state_dict(state_dict)
    tr = Trainer(model, config, device, seed=0)
    reset_counts()
    logs = tr.grad_step(tr.batch_to_device(batch), tr.generator)
    torch.cuda.synchronize()
    return model, logs, read_counts()


def group_norms(model) -> dict:
    """Each parameter group's gradient norm (float64 sums), and the global
    one."""
    from memotr_tpu_torch.engine.trainer import param_groups
    norms = {}
    for g, ps in param_groups(model).items():
        sq = [(p.grad.double() ** 2).sum() for p in ps if p.grad is not None]
        norms[g] = float(torch.stack(sq).sum().sqrt()) if sq else 0.0
    norms["global"] = float(np.sqrt(sum(v ** 2 for v in norms.values())))
    return norms


def compare_grads(tag, a, b, rtol) -> float:
    """Two models' gradients: every group norm within ``rtol`` (phase
    13's measure) and the relative L2 of the difference over all of them;
    returns the largest norm change."""
    na, nb = group_norms(a), group_norms(b)
    rels = {g: abs(na[g] - nb[g]) / max(abs(nb[g]), 1e-30) for g in nb}
    diff = sum(float(((pa.grad.double() - pb.grad.double()) ** 2).sum())
               for pa, pb in zip(a.parameters(), b.parameters())
               if pb.grad is not None)
    l2 = np.sqrt(diff) / max(nb["global"], 1e-30)
    for g, rel in rels.items():
        say(tag, f"grad norm {g}: {na[g]:.6e} vs {nb[g]:.6e} (rel "
            f"{rel:.2e}, tolerance {rtol})")
        assert rel <= rtol or na[g] == nb[g], (tag, g, na[g], nb[g])
    say(tag, f"relative L2 of the gradients' difference {l2:.2e} "
        f"(tolerance {rtol})")
    assert l2 <= rtol, (tag, l2)
    return max(rels.values())


def phase_checkpoint(device) -> dict:
    """Phase 27: ``USE_CHECKPOINT`` at 896x1536.  A bf16 deformable T=5
    step off then on (same weights and batch, after an untimed step of
    the same shapes): K1 forward launches doubled (the recompute runs the
    kernel), backward unchanged, peak memory and host ms of each; a windowed T=2 step off then on: K2 (and the
    decoder's K1) forward doubled, backward unchanged; a float32 T=1 step
    on ``scaled_weights_`` off and on: gradients within phase 13's
    tolerance."""
    from memotr_tpu_torch.models.memotr import build_model
    tag = "27 checkpoint"
    res = {}
    for name, config, t, per_frame in (
            ("deformable", TRAIN_CONFIG, CKPT_T,
             {"msda_fwd": 12, "msda_bwd": 12, "window_attn_fwd": 0,
              "window_attn_bwd": 0}),
            ("windowed", WINDOWED_TRAIN_CONFIG, 2,
             {"msda_fwd": 6, "msda_bwd": 6, "window_attn_fwd": 12,
              "window_attn_bwd": 12})):
        sd = random_weights_(build_model(config)).state_dict()
        batch = train_batch(t, seed=50)
        # a step of these shapes first, so that neither timed step pays
        # for cuDNN's and cuBLAS's first calls (phases 12 and 15 ran T=2
        # and T=5 already in a whole run, not in a run of this phase alone)
        train_once(config, sd, batch, device)
        runs = {}
        for ckpt in (False, True):
            trainer, logs, counts, ms, peak = train_once(
                dict(config, USE_CHECKPOINT=ckpt), sd, batch, device)
            del trainer
            want = {k: n * t * (2 if ckpt and k.endswith("fwd") else 1)
                    for k, n in per_frame.items()}
            assert counts == want, (tag, name, ckpt, counts, want)
            runs[ckpt] = {"counts": counts, "ms": ms, "peak_gib": peak,
                          "total_loss": float(logs["total_loss"])}
            say(tag, f"{name} T={t} USE_CHECKPOINT={ckpt}: {ms:.1f} ms "
                f"(host wall, synchronized), peak {peak:.2f} GiB "
                f"(max_memory_allocated less the memory held before), "
                f"total_loss "
                f"{runs[ckpt]['total_loss']:.5f}; launches " + ", ".join(
                    f"{k} {v}" for k, v in counts.items()) + " ok")
        off, on = runs[False], runs[True]
        rel = abs(on["total_loss"] - off["total_loss"]) / abs(
            off["total_loss"])
        assert rel <= TRAIN_LOSS_RTOL, (tag, name, off, on)
        say(tag, f"{name}: forward launches doubled, backward unchanged; "
            f"peak {off['peak_gib']:.2f} -> {on['peak_gib']:.2f} GiB "
            f"({on['peak_gib'] / off['peak_gib']:.3f}x), host "
            f"{off['ms']:.1f} -> {on['ms']:.1f} ms "
            f"({on['ms'] / off['ms']:.3f}x); total_loss rel {rel:.2e}")
        res[name] = {"T": t, "off": off, "on": on}
    cfg = dict(TRAIN_CONFIG, DTYPE="float32")
    sd = scaled_weights_(build_model(cfg)).state_dict()
    batch = train_batch(1, seed=40)
    off, _, c_off = grad_step_once(cfg, sd, batch, device)
    on, _, c_on = grad_step_once(dict(cfg, USE_CHECKPOINT=True), sd, batch,
                                 device)
    assert c_on["msda_fwd"] == 2 * c_off["msda_fwd"] == 24, (c_off, c_on)
    res["f32_norm_change"] = compare_grads(
        tag + " f32", on, off, TRAIN_NORM_RTOL)
    return res


def phase_options(device) -> dict:
    """Phase 28: ``EXTRA_TRACK_ATTN`` and ``DROPOUT`` at 896x1536.  A
    float32 deformable T=2 step (TF32 off, ``scaled_weights_``) with both:
    finite losses, live gradients in every ``track_attn`` and ``norm4``;
    the same step with ``USE_CHECKPOINT`` from the same weights, batch and
    dropout seed: gradients within phase 13's tolerance (the recompute
    draws the forward's masks).  Then the bf16 windowed model at
    ``DROPOUT`` 0.1: a T=2 step takes the composed route (0 K2 launches),
    and the same model streams 2 frames through K2, 12 a frame."""
    from memotr_tpu_torch.models.memotr import build_model
    tag = "28 options"
    res = {}
    cfg = dict(TRAIN_CONFIG, DTYPE="float32", EXTRA_TRACK_ATTN=True,
               DROPOUT=OPTIONS_DROPOUT)
    sd = scaled_weights_(build_model(cfg)).state_dict()
    batch = train_batch(2, seed=41)
    off, logs, c_off = grad_step_once(cfg, sd, batch, device)
    for k, v in logs.items():
        if isinstance(v, torch.Tensor):
            assert torch.isfinite(v).all(), (tag, k, v)
    attn = [(n, p) for n, p in off.named_parameters()
            if ".track_attn." in n or ".norm4." in n]
    assert len(attn) == 6 * (cfg["NUM_DEC_LAYERS"]
                             - cfg["MERGE_DET_TRACK_LAYER"]), len(attn)
    for n, p in attn:
        assert p.grad is not None and p.grad.abs().max() > 0, n
    say(tag, f"float32 T=2, EXTRA_TRACK_ATTN and DROPOUT "
        f"{OPTIONS_DROPOUT}: total_loss {float(logs['total_loss']):.5f} "
        f"(finite), {len(attn)} track_attn / norm4 tensors with a live "
        f"gradient; launches " + ", ".join(f"{k} {v}" for k, v in
                                           c_off.items()))
    on, logs_on, c_on = grad_step_once(dict(cfg, USE_CHECKPOINT=True), sd,
                                       batch, device)
    assert c_on["msda_fwd"] == 2 * c_off["msda_fwd"] == 48, (c_off, c_on)
    assert c_on["msda_bwd"] == c_off["msda_bwd"] == 24, (c_off, c_on)
    rel = abs(float(logs_on["total_loss"]) - float(logs["total_loss"])) \
        / abs(float(logs["total_loss"]))
    say(tag, f"with USE_CHECKPOINT: total_loss rel {rel:.2e}; msda_fwd "
        f"{c_on['msda_fwd']} = 2 x {c_off['msda_fwd']}")
    assert rel <= TRAIN_LOSS_RTOL, rel
    res["ckpt_norm_change"] = compare_grads(tag, on, off, TRAIN_NORM_RTOL)
    del on, off
    wcfg = dict(WINDOWED_TRAIN_CONFIG, DROPOUT=OPTIONS_DROPOUT)
    wsd = random_weights_(build_model(wcfg)).state_dict()
    trainer, logs, counts, ms, _ = train_once(wcfg, wsd, train_batch(2, 42),
                                              device)
    want = {"msda_fwd": 12, "msda_bwd": 12, "window_attn_fwd": 0,
            "window_attn_bwd": 0}
    assert counts == want, (tag, counts)
    say(tag, f"windowed bf16 T=2 at DROPOUT {OPTIONS_DROPOUT}: {ms:.1f} ms, "
        f"the composed route: " + ", ".join(f"{k} {v}" for k, v in
                                           counts.items()) + " ok")
    model = trainer.model.eval()
    _, scounts, _, _ = stream(tag, model, dict(WINDOWED_CONFIG,
                                               DROPOUT=OPTIONS_DROPOUT),
                              synthetic_frames(2, seed=3), device)
    assert scounts["window_attn_fwd"] == 12 * 2, scounts
    say(tag, f"the same model streams 2 frames: window_attn_fwd "
        f"{scounts['window_attn_fwd']} = 12 x 2, msda_fwd "
        f"{scounts['msda_fwd']} ok")
    res["windowed_dropout_train"] = counts
    res["windowed_dropout_stream"] = scounts
    return res


# ------------------------------------------------ several processes (29)
TORCHRUN_TIMEOUT = 420
TORCHRUN_STEPS = 10          # epoch 0 of phase 22's tree: 10 clips of T=2
RANKS_TIMEOUT = 420
RANKS_VIDEOS = {"val": (("dancetrack0011", 4), ("dancetrack0012", 4))}
TORCHRUN_LAUNCH = '''
import json, runpy, sys
import torch.distributed as dist
sys.argv[0] = "memotr_tpu_torch.main"
runpy.run_module("memotr_tpu_torch.main", run_name="__main__")
from memotr_tpu_torch.ops import msda_cuda
print(json.dumps({"backend": dist.get_backend(), "rank": dist.get_rank(),
                  "world": dist.get_world_size(),
                  "msda_fwd": msda_cuda.launches,
                  "msda_bwd": msda_cuda.bwd_launches}), flush=True)
dist.destroy_process_group()
'''


def run_processes(cmds, timeout, what, env=None):
    """Starts every command (its own session), waits for all; kills every
    process group left at the timeout.  A process that fails fails the
    phase.  Returns their stdouts."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here, **(env or {}))
    procs = [subprocess.Popen(c, cwd=here, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              start_new_session=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, \
            f"{what} process {i} failed ({p.returncode}):\n{err[-6000:]}"
    return [out for out, _ in outs]


def phase_torchrun(device, tmp) -> dict:
    """Phase 29a: ``torchrun --standalone --nproc_per_node 1`` of
    ``memotr_tpu_torch.main --multi-host --mode train`` (the module run as
    ``-m`` runs it, then the launches printed) on phase 22's train tree
    for one epoch: the NCCL group, K1 forward and backward 12 x T every
    step, and rank 0's checkpoint and scalars."""
    from memotr_tpu_torch.config import yaml_to_dict
    tag = "29 torchrun"
    root = os.path.join(tmp, "datasets")
    write_tree(root, {"train": ENTRY_VIDEOS["train"]}, seed=50)
    yaml_path = os.path.join(tmp, "train_dancetrack.yaml")
    entry_yaml(ENTRY_YAML, yaml_path)
    launch = os.path.join(tmp, "launch.py")
    with open(launch, "w") as f:
        f.write(TORCHRUN_LAUNCH)
    out = os.path.join(tmp, "run")
    t0 = time.perf_counter()
    stdout, = run_processes([[
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc_per_node", "1", launch, "--multi-host", "--mode", "train",
        "--config-path", yaml_path, "--data-root", root, "--outputs-dir",
        out, "--epochs", "1"]], TORCHRUN_TIMEOUT, "torchrun")
    wall = time.perf_counter() - t0
    rec = json.loads(stdout.strip().splitlines()[-1])
    cfg = yaml_to_dict(yaml_path)
    per_step = 2 * (cfg["NUM_ENC_LAYERS"] + cfg["NUM_DEC_LAYERS"])
    with open(os.path.join(out, "train", "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    assert rec["backend"] == "nccl" and rec["world"] == 1, rec
    assert rec["msda_fwd"] == rec["msda_bwd"] == TORCHRUN_STEPS * per_step, \
        rec
    assert os.path.exists(os.path.join(out, "checkpoint_0.pth"))
    assert scalars and all(np.isfinite(r["total_loss"]) for r in scalars)
    say(tag, f"torchrun --nproc_per_node 1 main --multi-host --mode train, "
        f"1 epoch in {wall:.1f} s (process start included): backend "
        f"{rec['backend']}, {rec['msda_fwd'] // per_step} steps of T=2 at "
        f"{per_step} K1 forward and backward launches each (totals "
        f"{rec['msda_fwd']} / {rec['msda_bwd']}); checkpoint_0.pth by rank "
        f"0; scalars.jsonl total_loss {scalars[-1]['total_loss']:.4f}")
    return {"wall_s": wall, **rec}


def ranks_config() -> dict:
    """Phase 29b's training config: phase 13's float32 step (TF32 off)."""
    return dict(TRAIN_CONFIG, DTYPE="float32")


def two_rank_worker(rank: int, port: int, tmp: str) -> None:
    """One of phase 29b's two ranks on the one card: a gloo group over
    CUDA tensors (NCCL refuses two ranks on one device), started here;
    the port's code takes the group it finds.  One float32 train step on
    its clip (rank 1 from perturbed weights, which the Trainer's broadcast
    replaces), a MetricLog sync, and a sharded submit; results to
    ``tmp/rank<r>.pt``."""
    import torch.distributed as dist

    from memotr_tpu_torch.engine import submit as port_submit
    from memotr_tpu_torch.engine.trainer import BATCH_KEYS
    from memotr_tpu_torch.log.logger import MetricLog
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = torch.load(os.path.join(tmp, "init.pt"))
    if rank == 1:
        sd = {k: v + 0.5 if v.is_floating_point() else v
              for k, v in sd.items()}
    data = np.load(os.path.join(tmp, "batch.npz"))
    batch = {k: data[k][rank:rank + 1] for k in BATCH_KEYS}
    trainer, logs, counts, ms, _ = train_once(ranks_config(), sd, batch,
                                              device)
    model = trainer.model
    res = {"counts": counts, "ms": ms,
           "logs": {k: float(logs[k]) for k in ("total_loss", "grad_norm",
                                                "n_gts")},
           "grads": {n: p.grad.cpu() for n, p in model.named_parameters()
                     if p.grad is not None},
           "state": {k: v.cpu() for k, v in model.state_dict().items()}}
    del trainer, model
    log = MetricLog()
    for v in ([1.0, 2.0], [3.0, 4.0, 5.0])[rank]:
        log.update("loss", v)
    log.sync()
    res["sync"] = (log.metrics["loss"].total_sum,
                   log.metrics["loss"].total_count)
    streamed = []
    orig = port_submit.stream_sequences

    def recording(dataset_name, sequences, *args, **kwargs):
        streamed.extend(name for name, _ in sequences)
        return orig(dataset_name, sequences, *args, **kwargs)
    port_submit.stream_sequences = recording
    with open(os.path.join(tmp, "submit.json")) as f:
        port_submit.submit(json.load(f), device)
    res["streamed"] = streamed
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_two_ranks(device, tmp) -> dict:
    """Phase 29b: two ranks on the card over gloo, one 896x1536 T=2 clip
    each, one float32 step: the parameters equal on both ranks bit for
    bit, and one process's step on both clips (B=2) within phase 13's
    tolerance (loss, gradient norm, and rank 0's clipped gradients held
    to that step's by ``compare_grads``: each group's norm and the
    relative L2 of the difference); MetricLog.sync's
    global totals; a two-sequence submit, one sequence a rank, whose
    union equals one process's files byte for byte."""
    from memotr_tpu_torch.checkpoint.files import save_checkpoint
    from memotr_tpu_torch.config import dict_to_yaml, yaml_to_dict
    from memotr_tpu_torch.data.loader import collate_clips
    from memotr_tpu_torch.engine.submit import submit
    from memotr_tpu_torch.models.memotr import build_model
    tag = "29 two ranks"
    cfg = ranks_config()
    torch.save(scaled_weights_(build_model(cfg)).state_dict(),
               os.path.join(tmp, "init.pt"))
    batch = collate_clips([synthetic_clip(2, 60), synthetic_clip(2, 61)],
                          cfg["MAX_GTS"])
    np.savez(os.path.join(tmp, "batch.npz"), **batch)
    # the submit: a run directory as train() writes it, two val videos
    root = os.path.join(tmp, "datasets")
    write_tree(root, RANKS_VIDEOS, seed=70)
    yaml_cfg = yaml_to_dict(ENTRY_YAML)
    runs = {}
    for name in ("ranks", "one"):
        run = os.path.join(tmp, name)
        os.makedirs(os.path.join(run, "train"))
        dict_to_yaml(yaml_cfg, os.path.join(run, "train", "config.yaml"))
        runs[name] = run
    model = random_weights_(build_model(yaml_cfg))
    for run in runs.values():
        save_checkpoint(os.path.join(run, "checkpoint_0.pth"), model)
    del model
    sub = dict(yaml_cfg, DATA_ROOT=root, SUBMIT_DATA_SPLIT="val",
               SUBMIT_MODEL="checkpoint_0.pth", DET_SCORE_THRESH=ENTRY_THRESH,
               TRACK_SCORE_THRESH=ENTRY_THRESH,
               RESULT_SCORE_THRESH=ENTRY_THRESH)
    with open(os.path.join(tmp, "submit.json"), "w") as f:
        json.dump(dict(sub, SUBMIT_DIR=runs["ranks"]), f)
    port = free_port()
    t0 = time.perf_counter()
    run_processes([[sys.executable, "-c",
                    f"import chip_smoke as c; c.two_rank_worker({r}, "
                    f"{port}, {tmp!r})"] for r in range(2)],
                  RANKS_TIMEOUT, "rank")
    wall = time.perf_counter() - t0
    r0, r1 = (torch.load(os.path.join(tmp, f"rank{r}.pt"))
              for r in range(2))
    per_step = {"msda_fwd": 24, "msda_bwd": 24, "window_attn_fwd": 0,
                "window_attn_bwd": 0}
    for r in (r0, r1):
        assert r["counts"] == per_step, r["counts"]
        assert r["sync"] == (15.0, 5), r["sync"]
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    say(tag, f"2 ranks (gloo, CUDA tensors, one card), one T=2 clip each, "
        f"{wall:.1f} s with process start: parameters equal on both ranks "
        f"bit for bit; launches a rank " + ", ".join(
            f"{k} {v}" for k, v in r0["counts"].items())
        + f"; MetricLog.sync (15.0, 5) on both")
    # one process, both clips
    trainer, logs, counts, ms, _ = train_once(cfg, torch.load(
        os.path.join(tmp, "init.pt")), batch, device)
    for k in ("total_loss", "grad_norm"):
        rel = abs(r0["logs"][k] - float(logs[k])) / abs(float(logs[k]))
        say(tag, f"{k}: ranks {r0['logs'][k]:.7f}, one process "
            f"{float(logs[k]):.7f} (rel {rel:.2e})")
        assert rel <= (TRAIN_LOSS_RTOL if k == "total_loss"
                       else TRAIN_NORM_RTOL), (k, rel)
    assert r0["logs"]["n_gts"] == float(logs["n_gts"]), r0["logs"]
    ranks = build_model(cfg).to(device)
    for n, p in ranks.named_parameters():
        if n in r0["grads"]:
            p.grad = r0["grads"][n].to(device)
    change = compare_grads(tag, ranks, trainer.model, TRAIN_NORM_RTOL)
    say(tag, f"one process on both clips (B=2): n_gts "
        f"{int(r0['logs']['n_gts'])} equal, rank 0's clipped gradients "
        f"within {TRAIN_NORM_RTOL} of its")
    del trainer, ranks
    submit(dict(sub, SUBMIT_DIR=runs["one"]), device)
    names = [v for v, _ in RANKS_VIDEOS["val"]]
    assert [r0["streamed"], r1["streamed"]] == [names[:1], names[1:]], \
        (r0["streamed"], r1["streamed"])
    for v in names:
        with open(os.path.join(runs["ranks"], "val", "tracker",
                               f"{v}.txt")) as f:
            got = f.read()
        with open(os.path.join(runs["one"], "val", "tracker",
                               f"{v}.txt")) as f:
            assert got == f.read(), v
        assert got, v
    say(tag, f"submit: rank 0 streamed {r0['streamed']}, rank 1 "
        f"{r1['streamed']}; the union equals one process's txt byte for "
        f"byte")
    return {"wall_s": wall, "counts_per_rank": r0["counts"],
            "norm_change": change,
            "rank_ms": [r0["ms"], r1["ms"]], "one_process_ms": ms}


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
    phase_conv_tail(device)
    say("30 conv_tail", f"done in {time.perf_counter() - t0:.1f} s")

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
    t0 = time.perf_counter()
    phase_train_f32(scaled_weights_(build_model(HYBRID_TRAIN_CONFIG)),
                    device, "21 hybrid train f32", HYBRID_TRAIN_CONFIG,
                    WINDOWED_TRAIN_NORM_RTOL)
    say("21 hybrid train f32", f"done in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        entry = phase_train_entry(device, tmp)
        say("22 train entry", f"done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        evaluated = phase_eval(device, entry["paths"])
        say("23 eval", f"done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        distilled = phase_distill(device, entry["paths"],
                                  entry["windowed_per_frame"],
                                  entry["windowed"]["iteration_ms"])
        say("24 distill", f"done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        served = phase_serving(device, entry["paths"])
        say("25 serving", f"done in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        campaign_errs = phase_campaign_kernels(device)
        campaign = phase_campaign(device, tmp)
        say("26 campaign", f"done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ckpt = phase_checkpoint(device)
    say("27 checkpoint", f"done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    options = phase_options(device)
    say("28 options", f"done in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for sub in ("torchrun", "ranks"):
            os.makedirs(os.path.join(tmp, sub))
        torchrun = phase_torchrun(device, os.path.join(tmp, "torchrun"))
        ranks = phase_two_ranks(device, os.path.join(tmp, "ranks"))
        say("29 processes", f"done in {time.perf_counter() - t0:.1f} s")
    say("all", f"{time.perf_counter() - t_all:.1f} s")
    campaign_launches = {k: sum(r["launches"][k] for r in campaign.values())
                         for k in campaign_errs}

    k1, k2 = k1_times["encoder"], k2_times["window_l0"]
    k1b, k2b = k1b_times["encoder"], k2b_times["window_l0"]
    print(json.dumps({"train_entry": {
        "config": ENTRY_YAML, "card": card, **entry["train"],
        "resume": entry["resume"], "submit": entry["submit"],
        "data": entry["data"], "windowed": entry["windowed"]}}), flush=True)
    print(json.dumps({"eval": {"config": ENTRY_YAML, "card": card,
                               **evaluated},
                      "distill": {"config": ENTRY_WINDOWED_YAML,
                                  "teacher": ENTRY_YAML, "card": card,
                                  **distilled}}), flush=True)
    print(json.dumps({"serving": {"card": card, "canvas": list(CANVAS),
                                  **served}}), flush=True)
    print(json.dumps({"campaign": {"card": card, "variants": campaign,
                                   "kernel_errors": campaign_errs}}),
          flush=True)
    print(json.dumps({"checkpoint": {"card": card, **ckpt},
                      "options": {"card": card, **options},
                      "torchrun": {"card": card, **torchrun},
                      "two_ranks": {"card": card, **ranks}}), flush=True)
    print(card, flush=True)
    ck_d, ck_w = ckpt["deformable"], ckpt["windowed"]
    print(json.dumps({"kernels": [
        {"name": "msda_fwd", "route": "cuda",
         "launches_campaign": campaign_launches["msda_fwd"],
         "max_abs_err_campaign": campaign_errs["msda_fwd"], "source": K1_SRC,
         "replaces": K1_TPU, "launches": counts["msda_fwd"],
         "max_abs_err": k1_err, "ms": k1["ms"], "device_ms": k1["device_ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None,
         "library_device_ms": None, "shape": "encoder B=1 Lq=25512 bf16",
         "launches_hybrid": hybrid_counts["msda_fwd"],
         "launches_batched": batched_counts["msda_fwd"],
         "launches_conv": conv_counts["msda_fwd"],
         "launches_train_conv": conv_train_counts["msda_fwd"],
         "launches_train_entry": entry["counts"]["msda_fwd"],
         "launches_train_entry_windowed": entry["windowed_counts"]["msda_fwd"],
         "launches_eval": evaluated["specific"]["launches"]
         + evaluated["continue"]["launches"],
         "launches_distill": distilled["counts"]["msda_fwd"],
         "launches_serving": {
             m: served[m]["launches"]["msda_fwd"]
             for m in ("deformable", "windowed")},
         "launches_demo": served["launches_demo"],
         "launches_checkpoint": {
             "deformable_T5": [ck_d["off"]["counts"]["msda_fwd"],
                               ck_d["on"]["counts"]["msda_fwd"]],
             "windowed_T2": [ck_w["off"]["counts"]["msda_fwd"],
                             ck_w["on"]["counts"]["msda_fwd"]]},
         "launches_torchrun": torchrun["msda_fwd"],
         "launches_two_ranks": ranks["counts_per_rank"]["msda_fwd"],
         "encoder_b2": {k: k1_times["encoder_b2"][k] for k in (
             "ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
             "bound_by")}},
        {"name": "window_attn_fwd", "route": "cuda",
         "launches_campaign": campaign_launches["window_attn_fwd"],
         "max_abs_err_campaign": campaign_errs["window_attn_fwd"], "source": K2_SRC,
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
         "launches_train_entry_windowed":
             entry["windowed_counts"]["window_attn_fwd"],
         "launches_distill": distilled["counts"]["window_attn_fwd"],
         "launches_serving": served["windowed"]["launches"][
             "window_attn_fwd"],
         "launches_checkpoint": {"windowed_T2": [
             ck_w["off"]["counts"]["window_attn_fwd"],
             ck_w["on"]["counts"]["window_attn_fwd"]]},
         "launches_dropout_train": options["windowed_dropout_train"][
             "window_attn_fwd"],
         "launches_dropout_stream": options["windowed_dropout_stream"][
             "window_attn_fwd"],
         **{case: {k: k2_times[case][k] for k in (
             "ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
             "library_device_ms", "bound_ms", "bound_by")}
            for case in ("window_l0_b2", "grid_l0_b2")}},
        {"name": "msda_bwd", "route": "cuda",
         "launches_campaign": campaign_launches["msda_bwd"],
         "max_abs_err_campaign": campaign_errs["msda_bwd"], "source": K1B_SRC,
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
         "launches_train_windowed": win_counts["msda_bwd"],
         "launches_train_entry": entry["counts"]["msda_bwd"],
         "launches_train_entry_windowed": entry["windowed_counts"]["msda_bwd"],
         "launches_distill": distilled["counts"]["msda_bwd"],
         "launches_checkpoint": {
             "deformable_T5": [ck_d["off"]["counts"]["msda_bwd"],
                               ck_d["on"]["counts"]["msda_bwd"]],
             "windowed_T2": [ck_w["off"]["counts"]["msda_bwd"],
                             ck_w["on"]["counts"]["msda_bwd"]]},
         "launches_torchrun": torchrun["msda_bwd"],
         "launches_two_ranks": ranks["counts_per_rank"]["msda_bwd"]},
        {"name": "window_attn_bwd", "route": "cuda",
         "launches_campaign": campaign_launches["window_attn_bwd"],
         "max_abs_err_campaign": campaign_errs["window_attn_bwd"], "source": K2B_SRC,
         "replaces": K2B_TPU, "launches": win_counts["window_attn_bwd"],
         "launches_per_step": {
             "windowed": [c["window_attn_bwd"] for c in win_steps],
             "hybrid": [c["window_attn_bwd"] for c in hyb_steps]},
         "launches_train_entry_windowed":
             entry["windowed_counts"]["window_attn_bwd"],
         "launches_distill": distilled["counts"]["window_attn_bwd"],
         "launches_checkpoint": {"windowed_T2": [
             ck_w["off"]["counts"]["window_attn_bwd"],
             ck_w["on"]["counts"]["window_attn_bwd"]]},
         "launches_dropout_train": options["windowed_dropout_train"][
             "window_attn_bwd"],
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
