"""Sequence loading, preprocessing and multi-sequence evaluation.

Replaces the reference's subprocess call into TrackEval
(the reference's ``eval_engine.py:92-113`` invoking
``TrackEval/scripts/run_mot_challenge.py``) with an in-process evaluator:
MOT-challenge txt loading, the MOT17 distractor preprocessing step, HOTA +
CLEAR + Identity per sequence (optionally in a process pool), cross-sequence
combination, and a ``pedestrian_summary.txt`` writer so downstream tooling
keeps working.

The port's own copy of ``memotr_tpu/metrics/evaluator.py`` (numpy and scipy
only; the port imports nothing of the JAX package).
"""
from __future__ import annotations

import multiprocessing
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from .clear import clear_sequence, combine_clear
from .hota import combine_hota, hota_sequence, summarize as hota_summary
from .identity import combine_identity, identity_sequence
from .vace import combine_vace, vace_sequence
from .ideucl import combine_ideucl, ideucl_sequence
from .count import combine_count, count_sequence
from .similarity import build_sequence_data, iou_xywh

# MOT17 GT class conventions (TrackEval mot_challenge_2d_box.py)
PEDESTRIAN = 1
MOT17_DISTRACTORS = (2, 7, 8, 12)


def load_mot_file(path: str) -> Dict[int, List[Tuple]]:
    """MOT txt -> {frame: [(id, x, y, w, h, conf, cls, vis), ...]}."""
    frames: Dict[int, List[Tuple]] = defaultdict(list)
    if not os.path.isfile(path):
        return frames
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 6:
                continue
            t, i = int(float(parts[0])), int(float(parts[1]))
            x, y, w, h = map(float, parts[2:6])
            conf = float(parts[6]) if len(parts) > 6 else 1.0
            cls = int(float(parts[7])) if len(parts) > 7 else PEDESTRIAN
            vis = float(parts[8]) if len(parts) > 8 else 1.0
            frames[t].append((i, x, y, w, h, conf, cls, vis))
    return frames


def preprocess_sequence(gt_frames: Dict[int, List[Tuple]],
                        pr_frames: Dict[int, List[Tuple]],
                        distractor_classes: Sequence[int] = (),
                        do_preproc: bool = True):
    """TrackEval-style preprocessing: drop tracker dets matched to distractor
    GTs, keep only valid (conf!=0) pedestrian GTs."""
    t_max = max([0] + list(gt_frames.keys()) + list(pr_frames.keys()))
    gt_out, pr_out = [], []
    for t in range(1, t_max + 1):
        gts = gt_frames.get(t, [])
        prs = pr_frames.get(t, [])
        pr_ids = np.asarray([p[0] for p in prs], np.int64)
        pr_boxes = np.asarray([p[1:5] for p in prs], np.float64).reshape(-1, 4)
        gt_ids = np.asarray([g[0] for g in gts], np.int64)
        gt_boxes = np.asarray([g[1:5] for g in gts], np.float64).reshape(-1, 4)
        gt_cls = np.asarray([g[6] for g in gts], np.int64)
        gt_conf = np.asarray([g[5] for g in gts], np.float64)

        keep_pr = np.ones(len(prs), bool)
        if do_preproc and distractor_classes and len(gts) and len(prs):
            sim = iou_xywh(gt_boxes, pr_boxes)
            score = np.where(sim < 0.5 - np.finfo(float).eps, 0.0, sim)
            rows, cols = linear_sum_assignment(-score)
            ok = score[rows, cols] > np.finfo(float).eps
            rows, cols = rows[ok], cols[ok]
            is_distr = np.isin(gt_cls[rows], distractor_classes)
            keep_pr[cols[is_distr]] = False

        keep_gt = (gt_conf != 0) & (gt_cls == PEDESTRIAN) \
            if do_preproc else np.ones(len(gts), bool)
        gt_out.append((gt_ids[keep_gt], gt_boxes[keep_gt]))
        pr_out.append((pr_ids[keep_pr], pr_boxes[keep_pr]))
    return gt_out, pr_out


def evaluate_one_sequence(args) -> Dict:
    gt_path, pr_path, distractors, do_preproc = args
    gt = load_mot_file(gt_path)
    pr = load_mot_file(pr_path)
    gt_f, pr_f = preprocess_sequence(gt, pr, distractors, do_preproc)
    data = build_sequence_data(gt_f, pr_f)
    return {
        "hota": hota_sequence(data),
        "clear": clear_sequence(data),
        "identity": identity_sequence(data),
        "vace": vace_sequence(data),
        "ideucl": ideucl_sequence(data),
        "count": count_sequence(data),
    }


def evaluate_sequences(pairs: Sequence[Tuple[str, str]],
                       distractor_classes: Sequence[int] = (),
                       do_preproc: bool = True,
                       num_parallel: int = 8) -> Dict:
    """pairs: [(gt_txt, tracker_txt)] -> combined metric dict (percent).

    With ``num_parallel`` > 1 and more than one sequence, the sequences are
    scored in a pool of ``min(num_parallel, len(pairs))`` processes started
    by ``spawn``: the caller is a process with a CUDA context and live
    loader or writer threads, and a forked child would inherit whatever
    locks those threads hold.  So, as for any spawned pool, the caller's
    main module must be safe to import (its work behind ``if __name__ ==
    "__main__"``): each worker imports it.  The results do not depend on
    the pool."""
    jobs = [(g, p, tuple(distractor_classes), do_preproc) for g, p in pairs]
    if num_parallel > 1 and len(jobs) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(num_parallel, len(jobs))) as pool:
            seq_res = pool.map(evaluate_one_sequence, jobs)
    else:
        seq_res = [evaluate_one_sequence(j) for j in jobs]

    hota = combine_hota([r["hota"] for r in seq_res])
    clear = combine_clear([r["clear"] for r in seq_res])
    ident = combine_identity([r["identity"] for r in seq_res])
    vace = combine_vace([r["vace"] for r in seq_res])
    ideucl = combine_ideucl([r["ideucl"] for r in seq_res])
    count = combine_count([r["count"] for r in seq_res])

    out = hota_summary(hota)
    out.update({
        "MOTA": clear["MOTA"] * 100, "MOTP": clear["MOTP"] * 100,
        "MODA": clear["MODA"] * 100, "sMOTA": clear["sMOTA"] * 100,
        "CLR_Re": clear["CLR_Re"] * 100, "CLR_Pr": clear["CLR_Pr"] * 100,
        "CLR_F1": clear["CLR_F1"] * 100,
        "CLR_TP": clear["CLR_TP"], "CLR_FN": clear["CLR_FN"],
        "CLR_FP": clear["CLR_FP"], "IDSW": clear["IDSW"],
        "MT": clear["MT"], "PT": clear["PT"], "ML": clear["ML"],
        "Frag": clear["Frag"],
        "IDF1": ident["IDF1"] * 100, "IDR": ident["IDR"] * 100,
        "IDP": ident["IDP"] * 100,
        "IDTP": ident["IDTP"], "IDFN": ident["IDFN"], "IDFP": ident["IDFP"],
        "ATA": vace["ATA"] * 100, "SFDA": vace["SFDA"] * 100,
        "STDA": vace["STDA"],
        "IDEucl": ideucl["IDEucl"] * 100,
    })
    out.update(count)
    return out


def load_seqmap(path: str) -> List[str]:
    """Parse a TrackEval seqmap file: optional ``name`` header line, then one
    sequence name per line (TrackEval ``_get_seq_info``; the reference eval
    passes ``--SEQMAP_FILE {split}_seqmap.txt``, eval_engine.py:93-97)."""
    names: List[str] = []
    with open(path) as f:
        for i, line in enumerate(f):
            s = line.strip()
            if not s or (i == 0 and s.lower() == "name"):
                continue
            names.append(s.split(",")[0].strip())
    return names


def evaluate_mot_challenge(gt_dir: str, tracker_dir: str,
                           seq_names: Optional[Sequence[str]] = None,
                           dataset: str = "DanceTrack",
                           num_parallel: int = 8,
                           seqmap_file: Optional[str] = None) -> Dict:
    """Evaluate ``<tracker_dir>/<seq>.txt`` against
    ``<gt_dir>/<seq>/gt/gt.txt`` (MOT-challenge layout).

    A seqmap file, when given, selects the sequence subset to score (the
    reference always passes one — eval_engine.py:93-97); otherwise every GT
    subdirectory is evaluated."""
    if seq_names is None:
        if seqmap_file:
            seq_names = load_seqmap(seqmap_file)
        else:
            seq_names = sorted(
                n for n in os.listdir(gt_dir)
                if os.path.isdir(os.path.join(gt_dir, n)))
    pairs = [(os.path.join(gt_dir, s, "gt", "gt.txt"),
              os.path.join(tracker_dir, f"{s}.txt")) for s in seq_names]
    distractors = MOT17_DISTRACTORS if dataset.startswith("MOT17") else ()
    do_preproc = dataset.startswith("MOT17")
    return evaluate_sequences(pairs, distractors, do_preproc, num_parallel)


def write_summary(metrics: Dict, path: str):
    """pedestrian_summary.txt-compatible two-line format
    (eval_engine.py:117-123 parses this)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    keys = list(metrics.keys())
    with open(path, "w") as f:
        f.write(" ".join(keys) + "\n")
        f.write(" ".join(f"{float(metrics[k]):.5g}" for k in keys) + "\n")
