"""Identity metrics (IDF1/IDP/IDR, Ristani et al. 2016).

Independent numpy implementation matching the harness the reference invokes
(``TrackEval/trackeval/metrics/identity.py``): global
trajectory-level bipartite matching over per-frame IoU>=0.5 co-occurrence
counts, with FP/FN augmentation rows so unmatched trajectories pay their full
length.

The port's own copy of ``memotr_tpu/metrics/identity.py`` (numpy and scipy
only; the port imports nothing of the JAX package).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

THRESHOLD = 0.5


def identity_sequence(data: Dict) -> Dict[str, float]:
    res = {"IDTP": 0.0, "IDFN": 0.0, "IDFP": 0.0}
    if data["num_pr_dets"] == 0:
        res["IDFN"] = data["num_gt_dets"]
        return _finalize(res)
    if data["num_gt_dets"] == 0:
        res["IDFP"] = data["num_pr_dets"]
        return _finalize(res)

    n_gt, n_pr = data["num_gt_ids"], data["num_pr_ids"]
    overlap = np.zeros((n_gt, n_pr))
    gt_count = np.zeros(n_gt)
    pr_count = np.zeros(n_pr)
    for gids, pids, sim in zip(data["gt_ids"], data["pr_ids"],
                               data["similarity"]):
        gi, pi = np.nonzero(sim >= THRESHOLD)
        np.add.at(overlap, (gids[gi], pids[pi]), 1)
        gt_count[gids] += 1
        pr_count[pids] += 1

    # augmented square cost: real pairs cost (len_g - ov) + (len_p - ov);
    # unmatched gt/pr pay their full length on the diagonal extension
    n = n_gt + n_pr
    fn_mat = np.zeros((n, n))
    fp_mat = np.zeros((n, n))
    fp_mat[n_gt:, :n_pr] = 1e10
    fn_mat[:n_gt, n_pr:] = 1e10
    fn_mat[:n_gt, :n_pr] = gt_count[:, None]
    fn_mat[np.arange(n_gt), n_pr + np.arange(n_gt)] = gt_count
    fp_mat[:n_gt, :n_pr] = pr_count[None, :]
    fp_mat[n_gt + np.arange(n_pr), np.arange(n_pr)] = pr_count
    fn_mat[:n_gt, :n_pr] -= overlap
    fp_mat[:n_gt, :n_pr] -= overlap

    rows, cols = linear_sum_assignment(fn_mat + fp_mat)
    res["IDFN"] = float(fn_mat[rows, cols].sum())
    res["IDFP"] = float(fp_mat[rows, cols].sum())
    res["IDTP"] = float(gt_count.sum() - res["IDFN"])
    return _finalize(res)


def _finalize(res: Dict) -> Dict:
    tp, fn, fp = res["IDTP"], res["IDFN"], res["IDFP"]
    res["IDR"] = tp / max(1.0, tp + fn)
    res["IDP"] = tp / max(1.0, tp + fp)
    res["IDF1"] = tp / max(1.0, tp + 0.5 * fn + 0.5 * fp)
    return res


def combine_identity(seq_results: List[Dict]) -> Dict:
    res = {k: sum(r[k] for r in seq_results) for k in ("IDTP", "IDFN", "IDFP")}
    return _finalize(res)
