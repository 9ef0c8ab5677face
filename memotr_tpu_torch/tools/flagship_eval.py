"""Encoder-family quality on synthetic tracking data, trained and scored
by the port (counterpart of ``tools/flagship_eval.py``).

The windowed, conv and hybrid encoders change the architecture of the
deformable one, so no released checkpoint speaks for their quality.  This
tool trains encoder variants from scratch, or through a transplant of a
trained deformable teacher, under one data set, seed and schedule on a
synthetic multi-object world, then submits and scores HOTA/DetA/AssA on a
held-out split through the port's engines (``engine/train.py: train``,
``engine/eval.py: eval_model``).  The worlds (``make_synvalue``, proxy v2;
``make_synvalue_v3``, v3 with ``PROXY_VERSION=3``), the configs
(``base_config``, ``VARIANTS``, ``TEACHER_VARIANTS``) and the run
bookkeeping are the JAX tool's, so the two packages' rows compare one for
one (``QUALITY.md``); the checkpoints are the port's ``.pth`` files.

Usage:
  python -m memotr_tpu_torch.tools.flagship_eval <workdir> <epochs> \
      <v1,v2,...> <s1,s2,...> [--single] [--device cuda|cpu]

Trains every (variant, seed) pair missing from <workdir>, each in a fresh
subprocess (crash isolation, bounded memory); a pair whose metrics file
exists is reused, and a pair with an epoch checkpoint resumes from its
newest.  ``--single`` runs the pairs in this process.  Prints a one-line
JSON summary at the end and writes it to ``<workdir>/flagship_eval.json``.
``<workdir>`` defaults to ``outputs/flagship_eval`` in this checkout.
``FLAGSHIP_EVAL_DEADLINE`` (epoch seconds) stops launching runs past it;
``FLAGSHIP_EVAL_HARD_STOP`` caps each run's subprocess timeout so that
none outlives it.  Runs on the GPU unless ``--device cpu``; without a
card it raises.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

H, W = 256, 320
PAD = 72            # world margin around the viewport for camera pan
N_FRAMES = 40
N_TRAIN_SEQS = 8
N_VAL_SEQS = 8
N_FRAMES_V3 = 96    # proxy v3: 2.4x longer sequences (same 256x320 canvas)
SUMMARY = ("HOTA", "DetA", "AssA", "MOTA", "IDF1")
RUN_TIMEOUT = 5400.0      # seconds a run's subprocess may take
MIN_RUN_WINDOW = 300.0    # a run is not started this close to the hard stop
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_synvalue(root: str, split: str, n_seqs: int, n_frames: int,
                  seed: int):
    """Synthetic tracking world: textured objects over a textured background
    with occlusions, scale/appearance change and camera pan (proxy v2)."""
    import PIL.Image
    rng = np.random.default_rng(seed)
    wh, ww = H + 2 * PAD, W + 2 * PAD
    for s in range(n_seqs):
        vdir = os.path.join(root, "DanceTrack", split, f"dancetrack{s:04d}")
        os.makedirs(os.path.join(vdir, "img1"), exist_ok=True)
        os.makedirs(os.path.join(vdir, "gt"), exist_ok=True)
        bg = rng.integers(40, 140, (wh, ww, 3), np.uint8)
        n_obj = int(rng.integers(12, 17))
        pos = rng.uniform([0, 0], [ww - 60, wh - 60], (n_obj, 2))
        vel = rng.uniform(-6, 6, (n_obj, 2))
        size = rng.integers(20, 44, (n_obj, 2)).astype(np.float64)
        tex = [rng.integers(100, 255, (int(size[i, 1]), int(size[i, 0]), 3),
                            np.uint8) for i in range(n_obj)]
        # per-object scale oscillation + appearance (brightness) drift
        s_amp = rng.uniform(0.05, 0.25, n_obj)
        s_frq = rng.uniform(0.05, 0.2, n_obj)
        s_phi = rng.uniform(0, 2 * np.pi, n_obj)
        a_amp = rng.uniform(0.05, 0.2, n_obj)
        a_frq = rng.uniform(0.05, 0.2, n_obj)
        a_phi = rng.uniform(0, 2 * np.pi, n_obj)
        # camera pan: smooth sinusoidal viewport offset inside the margin
        c_amp = rng.uniform(0.3, 1.0, 2) * (PAD - 4)
        c_frq = rng.uniform(0.04, 0.12, 2)
        c_phi = rng.uniform(0, 2 * np.pi, 2)
        zorder = rng.permutation(n_obj)      # fixed depth order -> occlusion
        lines = []
        for t in range(1, n_frames + 1):
            img = bg.copy()
            cam = (PAD + c_amp * np.sin(c_frq * t + c_phi)).astype(int)
            boxes = []
            for i in zorder:
                sc = 1.0 + s_amp[i] * np.sin(s_frq[i] * t + s_phi[i])
                w_i = max(10, int(round(size[i, 0] * sc)))
                h_i = max(10, int(round(size[i, 1] * sc)))
                xi = int(round(pos[i, 0]))
                yi = int(round(pos[i, 1]))
                xi = min(max(xi, 0), ww - w_i)
                yi = min(max(yi, 0), wh - h_i)
                bright = 1.0 + a_amp[i] * np.sin(a_frq[i] * t + a_phi[i])
                # nearest-neighbor texture rescale + brightness drift
                ry = (np.arange(h_i) * tex[i].shape[0]) // h_i
                rx = (np.arange(w_i) * tex[i].shape[1]) // w_i
                patch = np.clip(tex[i][ry][:, rx].astype(np.float32)
                                * bright, 0, 255).astype(np.uint8)
                img[yi:yi + h_i, xi:xi + w_i] = patch
                boxes.append((i, xi, yi, w_i, h_i))
            # viewport crop; GT clipped to view, kept when >=30% visible
            view = img[cam[1]:cam[1] + H, cam[0]:cam[0] + W]
            for i, xi, yi, w_i, h_i in boxes:
                vx0 = max(xi - cam[0], 0)
                vy0 = max(yi - cam[1], 0)
                vx1 = min(xi - cam[0] + w_i, W)
                vy1 = min(yi - cam[1] + h_i, H)
                if vx1 <= vx0 or vy1 <= vy0:
                    continue
                if (vx1 - vx0) * (vy1 - vy0) < 0.3 * w_i * h_i:
                    continue
                lines.append(f"{t},{i + 1},{vx0},{vy0},{vx1 - vx0},"
                             f"{vy1 - vy0},1,1,1\n")
            PIL.Image.fromarray(view).save(
                os.path.join(vdir, "img1", f"{t:08d}.jpg"))
            pos += vel
            for d, lim in ((0, ww), (1, wh)):
                over = (pos[:, d] < 0) | (pos[:, d] + size[:, d] > lim)
                vel[over, d] *= -1
                pos[:, d] = np.clip(pos[:, d], 0, lim - size[:, d])
        with open(os.path.join(vdir, "gt", "gt.txt"), "w") as f:
            f.write("".join(lines))


def make_synvalue_v3(root: str, split: str, n_seqs: int, n_frames: int,
                     seed: int):
    """Proxy v3: v2's world pushed toward DanceTrack statistics.
    Differences vs :func:`make_synvalue` (v2):

    - **near-uniform appearance** — 3 base textures per sequence shared by
      all objects (small per-object brightness offset only), DanceTrack's
      signature property (uniform outfits): association must come from
      motion/position continuity, not appearance;
    - **non-linear motion** — Ornstein-Uhlenbeck velocity noise + weak
      attraction to a slowly-moving formation center that re-samples its
      members every ~32 frames (clustering, crossovers, direction
      reversals) instead of v2's constant velocity + wall bounce;
    - **mid-sequence entry/exit** — ~40% of objects are born after frame 1
      (spawned at a world edge moving inward) and/or die before the end,
      exercising the newborn / miss-tolerance lifecycle paths
      (``models/runtime_tracker.py``) that v2's always-present objects
      never hit mid-sequence;
    - **depth by position** — per-frame painter's order by box bottom (a
      lower dancer occludes one behind), so occluder identity changes as
      objects cross, instead of v2's fixed z-order;
    - **96 frames** (2.4x v2) at the same 256x320 canvas: the training
      clips and the batched eval step have v2's shapes.

    GT format/visibility rule identical to v2 (MOT txt, >=30% visible).
    """
    import PIL.Image
    rng = np.random.default_rng(seed)
    wh, ww = H + 2 * PAD, W + 2 * PAD
    for s in range(n_seqs):
        vdir = os.path.join(root, "DanceTrack", split, f"dancetrack{s:04d}")
        os.makedirs(os.path.join(vdir, "img1"), exist_ok=True)
        os.makedirs(os.path.join(vdir, "gt"), exist_ok=True)
        bg = rng.integers(40, 140, (wh, ww, 3), np.uint8)
        n_obj = int(rng.integers(12, 17))
        # 3 shared base textures at a common nominal size; objects differ
        # only by a small brightness offset (appearance ~uniform)
        base_tex = [rng.integers(100, 255, (40, 28, 3), np.uint8)
                    for _ in range(3)]
        tex_of = rng.integers(0, 3, n_obj)
        tint = rng.uniform(0.85, 1.15, n_obj)
        size = rng.integers(20, 44, (n_obj, 2)).astype(np.float64)
        pos = rng.uniform([0, 0], [ww - 60, wh - 60], (n_obj, 2))
        vel = rng.uniform(-4, 4, (n_obj, 2))
        # birth/death: ~60% full-span; the rest enter after frame 1 (at an
        # edge, moving inward) and/or exit early.  Every life >= 12 frames.
        birth = np.ones(n_obj, int)
        death = np.full(n_obj, n_frames, int)
        for i in range(n_obj):
            r = rng.uniform()
            if r < 0.2:            # late birth
                birth[i] = int(rng.integers(2, n_frames - 12))
            elif r < 0.4:          # early death
                death[i] = int(rng.integers(birth[i] + 12, n_frames + 1)) \
                    if birth[i] + 12 <= n_frames else n_frames
            if birth[i] > 1:       # spawn at a world edge, moving inward
                edge = rng.integers(0, 4)
                if edge == 0:
                    pos[i] = [0, rng.uniform(0, wh - 60)]
                    vel[i, 0] = abs(vel[i, 0]) + 2
                elif edge == 1:
                    pos[i] = [ww - size[i, 0], rng.uniform(0, wh - 60)]
                    vel[i, 0] = -abs(vel[i, 0]) - 2
                elif edge == 2:
                    pos[i] = [rng.uniform(0, ww - 60), 0]
                    vel[i, 1] = abs(vel[i, 1]) + 2
                else:
                    pos[i] = [rng.uniform(0, ww - 60), wh - size[i, 1]]
                    vel[i, 1] = -abs(vel[i, 1]) - 2
        # scale oscillation (kept from v2; no appearance drift — that would
        # re-introduce an appearance cue)
        s_amp = rng.uniform(0.05, 0.25, n_obj)
        s_frq = rng.uniform(0.05, 0.2, n_obj)
        s_phi = rng.uniform(0, 2 * np.pi, n_obj)
        # camera pan as in v2
        c_amp = rng.uniform(0.3, 1.0, 2) * (PAD - 4)
        c_frq = rng.uniform(0.04, 0.12, 2)
        c_phi = rng.uniform(0, 2 * np.pi, 2)
        # formation center on a slow Lissajous path; membership re-sampled
        # every 32 frames
        f_amp = rng.uniform(0.25, 0.45, 2) * np.array([ww, wh])
        f_frq = rng.uniform(0.02, 0.05, 2)
        f_phi = rng.uniform(0, 2 * np.pi, 2)
        member = rng.uniform(size=n_obj) < 0.6
        vmax = 7.0
        lines = []
        for t in range(1, n_frames + 1):
            if t % 32 == 0:
                member = rng.uniform(size=n_obj) < 0.6
            img = bg.copy()
            cam = (PAD + c_amp * np.sin(c_frq * t + c_phi)).astype(int)
            center = np.array([ww / 2, wh / 2]) \
                + f_amp * np.sin(f_frq * t + f_phi)
            alive = (birth <= t) & (t <= death)
            boxes = []
            # painter's order: smaller bottom-y drawn first (occluded)
            order = np.argsort(pos[:, 1] + size[:, 1])
            for i in order:
                if not alive[i]:
                    continue
                sc = 1.0 + s_amp[i] * np.sin(s_frq[i] * t + s_phi[i])
                w_i = max(10, int(round(size[i, 0] * sc)))
                h_i = max(10, int(round(size[i, 1] * sc)))
                xi = min(max(int(round(pos[i, 0])), 0), ww - w_i)
                yi = min(max(int(round(pos[i, 1])), 0), wh - h_i)
                ry = (np.arange(h_i) * base_tex[tex_of[i]].shape[0]) // h_i
                rx = (np.arange(w_i) * base_tex[tex_of[i]].shape[1]) // w_i
                patch = np.clip(
                    base_tex[tex_of[i]][ry][:, rx].astype(np.float32)
                    * tint[i], 0, 255).astype(np.uint8)
                img[yi:yi + h_i, xi:xi + w_i] = patch
                boxes.append((i, xi, yi, w_i, h_i))
            view = img[cam[1]:cam[1] + H, cam[0]:cam[0] + W]
            for i, xi, yi, w_i, h_i in boxes:
                vx0 = max(xi - cam[0], 0)
                vy0 = max(yi - cam[1], 0)
                vx1 = min(xi - cam[0] + w_i, W)
                vy1 = min(yi - cam[1] + h_i, H)
                if vx1 <= vx0 or vy1 <= vy0:
                    continue
                if (vx1 - vx0) * (vy1 - vy0) < 0.3 * w_i * h_i:
                    continue
                lines.append(f"{t},{i + 1},{vx0},{vy0},{vx1 - vx0},"
                             f"{vy1 - vy0},1,1,1\n")
            PIL.Image.fromarray(view).save(
                os.path.join(vdir, "img1", f"{t:08d}.jpg"))
            # OU velocity + weak formation attraction; soft wall reflection
            pull = (center - pos) / np.array([ww, wh])
            acc = 1.2 * pull * member[:, None] + rng.normal(0, 0.9, (n_obj, 2))
            vel = np.clip(0.92 * vel + acc, -vmax, vmax)
            pos += vel
            for d, lim in ((0, ww), (1, wh)):
                over = (pos[:, d] < 0) | (pos[:, d] + size[:, d] > lim)
                vel[over, d] *= -1
                pos[:, d] = np.clip(pos[:, d], 0, lim - size[:, d])
        with open(os.path.join(vdir, "gt", "gt.txt"), "w") as f:
            f.write("".join(lines))


def base_config(root: str, outdir: str, encoder_type: str,
                epochs: int) -> dict:
    return {
        "DATASET": "DanceTrack", "DATA_ROOT": root, "OUTPUTS_DIR": outdir,
        "HIDDEN_DIM": 64, "FFN_DIM": 256, "NUM_FEATURE_LEVELS": 4,
        "NUM_HEADS": 8, "NUM_ENC_POINTS": 4, "NUM_DEC_POINTS": 4,
        "NUM_ENC_LAYERS": 3, "NUM_DEC_LAYERS": 3, "MERGE_DET_TRACK_LAYER": 1,
        "NUM_DET_QUERIES": 40, "DROPOUT": 0.0, "USE_DAB": True,
        "UPDATE_THRESH": 0.5, "LONG_MEMORY_LAMBDA": 0.01,
        "USE_CHECKPOINT": False, "CHECKPOINT_LEVEL": 2, "AUX_LOSS": True,
        "EXTRA_TRACK_ATTN": False, "PRETRAINED_MODEL": None, "RESUME": None,
        "SEED": 42, "EPOCHS": epochs, "BATCH_SIZE": 1, "NUM_WORKERS": 2,
        "ACCUMULATION_STEPS": 1, "ONLY_TRAIN_QUERY_UPDATER_AFTER": 999,
        "SAMPLE_STEPS": [max(1, epochs // 2)], "SAMPLE_LENGTHS": [2, 3],
        "SAMPLE_MODES": ["random_interval"], "SAMPLE_INTERVALS": [4],
        "COCO_SIZE": False, "OVERFLOW_BBOX": False, "REVERSE_CLIP": 0.0,
        "LR": 2e-4, "LR_BACKBONE": 2e-5, "LR_POINTS": 2e-5,
        "WEIGHT_DECAY": 1e-4, "CLIP_MAX_NORM": 0.1,
        "LR_SCHEDULER": "MultiStep",
        "LR_DROP_MILESTONES": [max(2, epochs - 2)], "LR_DROP_RATE": 0.1,
        "NO_GRAD_FRAMES": None,
        "MATCH_COST_CLASS": 2, "MATCH_COST_BBOX": 5, "MATCH_COST_GIOU": 2,
        "LOSS_WEIGHT_FOCAL": 2, "LOSS_WEIGHT_L1": 5, "LOSS_WEIGHT_GIOU": 2,
        "AUX_LOSS_WEIGHT": [1.0, 1.0], "TRACK_SLOTS": 24, "MAX_GTS": 20,
        "DTYPE": "float32", "MSDA_IMPL": "xla", "TP_DROP_RATE": 0.0,
        "FP_INSERT_RATE": 0.0, "MULTI_CHECKPOINT": False,
        "DET_SCORE_THRESH": 0.5, "TRACK_SCORE_THRESH": 0.5,
        "RESULT_SCORE_THRESH": 0.5, "MISS_TOLERANCE": 5,
        "USE_MOTION": False, "MOTION_MIN_LENGTH": 3, "MOTION_MAX_LENGTH": 5,
        "MOTION_LAMBDA": 0.5, "EVAL_THREADS": 1, "EVAL_DATA_SPLIT": "val",
        "EVAL_DIR": outdir, "EVAL_MODE": "specific", "EVAL_MODEL": None,
        "SUBMIT_DIR": outdir, "SUBMIT_MODEL": None, "SUBMIT_DATA_SPLIT": "val",
        "EVAL_SHORT_SIDE": H, "EVAL_MAX_SIDE": W,
        "TRAIN_SHORT_SIDES": [H], "TRAIN_MAX_SIZE": W,
        "FIXED_TRAIN_CANVAS": [H, W],
        "MESH_DEVICES": 1, "ENCODER_TYPE": encoder_type,
        # the 8 val sequences stream as 8 lanes of one batched step
        # (engine/submit.py BatchedSubmitter): one step's launches serve
        # all 8 sequences
        "SUBMIT_BATCH": 8,
    }


# named variants: (encoder_type, config overrides).  "@teacher" resolves to
# the deformable seed-42 teacher checkpoint of the same workdir and epochs
# (train it first: variant "deformable", seed 42).
VARIANTS = {
    "windowed": ("windowed", {}),
    "deformable": ("deformable", {}),
    "conv": ("conv", {}),
    "hybrid": ("hybrid", {}),
    "hybrid_lvl2": ("hybrid", {"HYBRID_DEFORM_MIN_LEVEL": 2}),
    "windowed_enc6": ("windowed", {"NUM_ENC_LAYERS": 6}),
    "deformable_enc6": ("deformable", {"NUM_ENC_LAYERS": 6}),
    "windowed_enc4": ("windowed", {"NUM_ENC_LAYERS": 4}),
    "windowed_win12": ("windowed", {"WINDOW_SIZE": 12}),
    "conv_enc6": ("conv", {"NUM_ENC_LAYERS": 6}),
    "windowed_prenorm": ("windowed", {"WINDOWED_PRENORM": True}),
    "windowed_prenorm_enc6": ("windowed", {"WINDOWED_PRENORM": True,
                                           "NUM_ENC_LAYERS": 6}),
    "windowed_sharedcpb": ("windowed", {"WINDOWED_SHARED_CPB": True}),
    # post-norm dense attention without warmup is the classic instability
    # recipe
    "windowed_warmup": ("windowed", {"WARMUP_ITERS": 300}),
    # quality levers: transplant and distillation from the teacher
    "windowed_transplant": ("windowed", {"PRETRAINED_MODEL": "@teacher"}),
    "windowed_distill": ("windowed", {"DISTILL_TEACHER": "@teacher"}),
    "windowed_transplant_distill": ("windowed",
                                    {"PRETRAINED_MODEL": "@teacher",
                                     "DISTILL_TEACHER": "@teacher"}),
    "hybrid_transplant": ("hybrid", {"PRETRAINED_MODEL": "@teacher"}),
    # deployment-width head-to-head
    "deformable_w256": ("deformable", {"HIDDEN_DIM": 256, "FFN_DIM": 1024}),
    "windowed_w256": ("windowed", {"HIDDEN_DIM": 256, "FFN_DIM": 1024}),
    "hybrid_w256": ("hybrid", {"HIDDEN_DIM": 256, "FFN_DIM": 1024}),
    "windowed_w256_pre6": ("windowed", {"HIDDEN_DIM": 256, "FFN_DIM": 1024,
                                        "WINDOWED_PRENORM": True,
                                        "NUM_ENC_LAYERS": 6}),
    # the transplant lever at deployment width: the teacher is the same
    # campaign's deformable_w256 seed-42 checkpoint (the 64-dim @teacher
    # cannot seed a 256-dim student)
    "windowed_w256_transplant": ("windowed",
                                 {"HIDDEN_DIM": 256, "FFN_DIM": 1024,
                                  "PRETRAINED_MODEL": "@teacher_w256"}),
    # hybrid at deployment width, from the same teacher
    "hybrid_w256_transplant": ("hybrid",
                               {"HIDDEN_DIM": 256, "FFN_DIM": 1024,
                                "PRETRAINED_MODEL": "@teacher_w256"}),
    # deployment width + shared-CPB rel-pos + transplant init
    "windowed_w256_transplant_cpb": ("windowed",
                                     {"HIDDEN_DIM": 256, "FFN_DIM": 1024,
                                      "PRETRAINED_MODEL": "@teacher_w256",
                                      "WINDOWED_SHARED_CPB": True}),
}

# "@teacher*" placeholder -> the variant whose seed-42 checkpoint serves as
# teacher/pretrain source (trained first in the same campaign workdir).
TEACHER_VARIANTS = {"@teacher": "deformable", "@teacher_w256": "deformable_w256"}


def run_dir(workdir: str, name: str, seed: int) -> str:
    """A run's outdir, suffixed by its seed: a run of another seed never
    reuses this one's files."""
    return os.path.join(workdir, f"{name}_s{seed}")


def teacher_ckpt(workdir: str, epochs: int,
                 variant: str = "deformable") -> str:
    return os.path.join(run_dir(workdir, variant, 42),
                        f"checkpoint_{epochs - 1}.pth")


def latest_complete_checkpoint(outdir: str):
    """Newest complete epoch checkpoint number in ``outdir``, or None.

    Only files named exactly ``checkpoint_<int>.pth`` count: a run killed
    while saving leaves ``checkpoint_<N>.pth.tmp``
    (``checkpoint/files.py: save_checkpoint``), which must neither crash
    the scan nor be resumed from."""
    if not os.path.isdir(outdir):
        return None
    ckpts = [int(m.group(1)) for f in os.listdir(outdir)
             for m in [re.fullmatch(r"checkpoint_(\d+)\.pth", f)] if m]
    return max(ckpts) if ckpts else None


def summary(metrics: dict) -> dict:
    return {k: round(float(metrics[k]), 3) for k in SUMMARY if k in metrics}


def metrics_of(workdir: str, name: str, seed: int, epochs: int):
    done = os.path.join(run_dir(workdir, name, seed), "val",
                        f"checkpoint_{epochs - 1}_metrics.json")
    if os.path.isfile(done):
        with open(done) as f:
            return summary(json.load(f))
    return None


def run_variant(root: str, workdir: str, name: str, epochs: int,
                seed: int = 42, device: str = "cuda") -> dict:
    """Trains and scores one (variant, seed) run in this process; returns
    its summary metrics.  A run already scored is reused; a run with an
    epoch checkpoint resumes from its newest (``RESUME``).  A variant with
    a ``@teacher*`` placeholder needs that teacher's last epoch
    checkpoint: without it this raises, where ``train`` would warn and
    train from scratch."""
    from ..engine.eval import eval_model
    from ..engine.train import train
    from ..log.logger import Logger

    got = metrics_of(workdir, name, seed, epochs)
    if got is not None:
        return got
    encoder_type, overrides = VARIANTS[name]
    outdir = run_dir(workdir, name, seed)
    cfg = base_config(root, outdir, encoder_type, epochs)
    cfg.update(overrides)
    cfg["SEED"] = seed
    for key in ("PRETRAINED_MODEL", "DISTILL_TEACHER"):
        tv = TEACHER_VARIANTS.get(cfg.get(key))
        if tv is not None:
            t = teacher_ckpt(workdir, epochs, tv)
            if not os.path.isfile(t):
                raise FileNotFoundError(
                    f"{name} needs the {tv} seed-42 teacher first ({t})")
            cfg[key] = t
    latest = latest_complete_checkpoint(outdir)
    if latest is not None:
        cfg["RESUME"] = os.path.join(outdir, f"checkpoint_{latest}.pth")
        print(f"[{name}_s{seed}] resuming from checkpoint_{latest}.pth",
              flush=True)
    train(cfg, device)
    metrics = eval_model(dict(cfg), outdir, f"checkpoint_{epochs - 1}.pth",
                         Logger(logdir=os.path.join(outdir, "val")), device)
    return summary(metrics)


def ensure_data(workdir: str) -> str:
    """Generates (once) the synthetic proxy data set of this workdir.

    ``PROXY_VERSION=3`` selects the v3 world (:func:`make_synvalue_v3`);
    the default is v2.  A workdir is pinned to the version that first
    generated it: mixing versions would pair runs against different data,
    so a marker of the other version is an error, not a regeneration.
    """
    root = os.path.join(workdir, "data")
    version = os.environ.get("PROXY_VERSION", "2")
    markers = {v: os.path.join(root, f".proxy_v{v}") for v in ("2", "3")}
    for other, path in markers.items():
        if other != version and os.path.isfile(path):
            raise RuntimeError(
                f"workdir {workdir} holds proxy v{other} data but "
                f"PROXY_VERSION={version}; use a fresh workdir per version")
    if not os.path.isfile(markers[version]):
        gen, n_frames = ((make_synvalue_v3, N_FRAMES_V3) if version == "3"
                         else (make_synvalue, N_FRAMES))
        gen(root, "train", N_TRAIN_SEQS, n_frames, seed=3)
        gen(root, "val", N_VAL_SEQS, n_frames, seed=99)
        with open(markers[version], "w") as f:
            f.write(f"proxy v{version}\n")
    return root


def run_timeout(hard_stop: float, now: float):
    """A run's subprocess timeout: ``RUN_TIMEOUT``, capped at the hard
    stop (0: none); None when the hard stop is under ``MIN_RUN_WINDOW``
    away, and the run is not started."""
    timeout = RUN_TIMEOUT
    if hard_stop:
        timeout = min(timeout, hard_stop - now)
        if timeout < MIN_RUN_WINDOW:
            return None
    return timeout


def launch(workdir: str, epochs: int, name: str, seed: int, device: str,
           timeout: float, log=None) -> int:
    """One run in a fresh process (``--single``), killed past ``timeout``
    seconds (``subprocess.TimeoutExpired``); its exit code.  ``log``: a
    file its output goes to, in place of this process's."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    return subprocess.call(
        [sys.executable, "-m", "memotr_tpu_torch.tools.flagship_eval",
         workdir, str(epochs), name, str(seed), "--single", "--device",
         device], env=env, timeout=timeout, stdout=log,
        stderr=None if log is None else subprocess.STDOUT)


def epoch_iterations(epochs: int, spans=None) -> list:
    """(T, iterations) of each epoch of a run of ``base_config``'s
    schedule: the clip length of the epoch's curriculum stage
    (``SAMPLE_STEPS``, ``SAMPLE_LENGTHS``) and the clip starts, ``span - T
    + 1`` a training sequence whose boxes span ``span`` frames (its first
    annotated frame to its last).  ``spans`` defaults to the v3 world's:
    ``N_TRAIN_SEQS`` sequences annotated from their first frame to their
    last, ``N_FRAMES_V3``."""
    spans = (N_FRAMES_V3,) * N_TRAIN_SEQS if spans is None else spans
    cfg = base_config("", "", "", epochs)
    lengths = cfg["SAMPLE_LENGTHS"]
    out = []
    for epoch in range(epochs):
        stage = sum(1 for s in cfg["SAMPLE_STEPS"] if epoch >= s)
        t = lengths[min(stage, len(lengths) - 1)]
        out.append((t, sum(span - t + 1 for span in spans)))
    return out


def single_run(root, workdir, name, epochs, seed, device) -> dict:
    """``run_variant`` in this process, with one JSON line of the run's
    wall seconds, peak device memory and TF32 settings."""
    import torch
    t0 = time.time()
    got = run_variant(root, workdir, name, epochs, seed, device)
    cuda = torch.device(device).type == "cuda"
    print(json.dumps({"run": f"{name}_s{seed}", "metrics": got,
                      "seconds": time.time() - t0,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30
                      if cuda else None,
                      "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                               "cudnn": torch.backends.cudnn.allow_tf32}}),
          flush=True)
    return got


def main(argv=None) -> dict:
    import argparse

    from ..engine.submit import resolve_device
    p = argparse.ArgumentParser("flagship_eval")
    p.add_argument("workdir", nargs="?",
                   default=os.path.join(REPO, "outputs", "flagship_eval"))
    p.add_argument("epochs", nargs="?", type=int, default=10)
    p.add_argument("names", nargs="?", default="windowed,deformable")
    p.add_argument("seeds", nargs="?", default="42")
    p.add_argument("--single", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = str(resolve_device(args.device))
    workdir = os.path.abspath(args.workdir)
    names = args.names.split(",")
    seeds = [int(s) for s in args.seeds.split(",")]
    root = ensure_data(workdir)
    deadline = float(os.environ.get("FLAGSHIP_EVAL_DEADLINE", "0") or 0)
    hard_stop = float(os.environ.get("FLAGSHIP_EVAL_HARD_STOP", "0") or 0)

    results = {}
    for name in names:
        for seed in seeds:
            key = f"{name}_s{seed}"
            got = metrics_of(workdir, name, seed, args.epochs)
            if got is None and args.single:
                got = single_run(root, workdir, name, args.epochs, seed,
                                 device)
            elif got is None:
                if deadline and time.time() > deadline:
                    print(f"!!! deadline passed, skipping {key}", flush=True)
                    continue
                timeout = run_timeout(hard_stop, time.time())
                if timeout is None:
                    print(f"!!! hard stop imminent, skipping {key}",
                          flush=True)
                    continue
                print(f"=== training {key} ===", flush=True)
                try:
                    rc = launch(workdir, args.epochs, name, seed, device,
                                timeout)
                except subprocess.TimeoutExpired:
                    print(f"!!! {key} timed out after {int(timeout)}s",
                          flush=True)
                    continue
                if rc != 0:
                    print(f"!!! {key} failed rc={rc}", flush=True)
                    continue
                got = metrics_of(workdir, name, seed, args.epochs)
            results[key] = got
            print(key, got, flush=True)
    with open(os.path.join(workdir, "flagship_eval.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
