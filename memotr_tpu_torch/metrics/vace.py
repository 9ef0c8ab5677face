"""VACE metrics (Manohar et al. 2006): ATA / STDA / FDA / SFDA.

Independent numpy implementation matching the harness the reference bundles
(``TrackEval/trackeval/metrics/vace.py``), relaxed variant:
per-frame IoU>=0.5 counts feed a trajectory-level temporal-IoU assignment
(ATA), and per-frame optimal spatial overlap gives FDA.

The port's own copy of ``memotr_tpu/metrics/vace.py`` (numpy and scipy
only; the port imports nothing of the JAX package).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

THRESHOLD = 0.5


def vace_sequence(data: Dict) -> Dict[str, float]:
    res = {"STDA": 0.0, "FDA": 0.0, "VACE_IDs": data["num_pr_ids"],
           "VACE_GT_IDs": data["num_gt_ids"], "num_non_empty_timesteps": 0}

    n_gt, n_pr = data["num_gt_ids"], data["num_pr_ids"]
    if n_gt and n_pr:
        overlap_count = np.zeros((n_gt, n_pr))
        gt_count = np.zeros(n_gt)
        pr_count = np.zeros(n_pr)
        both = np.zeros((n_gt, n_pr))
        for gids, pids, sim in zip(data["gt_ids"], data["pr_ids"],
                                   data["similarity"]):
            gi, pi = np.nonzero(sim >= THRESHOLD)
            np.add.at(overlap_count, (gids[gi], pids[pi]), 1)
            gt_count[gids] += 1
            pr_count[pids] += 1
            both[gids[:, None], pids[None, :]] += 1
        union = gt_count[:, None] + pr_count[None, :] - both
        temporal_iou = overlap_count / union
        rows, cols = linear_sum_assignment(-temporal_iou)
        res["STDA"] = float(temporal_iou[rows, cols].sum())

    for gids, pids, sim in zip(data["gt_ids"], data["pr_ids"],
                               data["similarity"]):
        n_g, n_d = len(gids), len(pids)
        if not (n_g or n_d):
            continue
        res["num_non_empty_timesteps"] += 1
        if not (n_g and n_d):
            continue
        rows, cols = linear_sum_assignment(-sim)
        res["FDA"] += float(sim[rows, cols].sum()) / (0.5 * (n_g + n_d))
    return _finalize(res)


def _finalize(res: Dict) -> Dict:
    denom = 0.5 * (res["VACE_IDs"] + res["VACE_GT_IDs"])
    res["ATA"] = res["STDA"] / denom if denom > 0 else 0.0
    res["SFDA"] = (res["FDA"] / res["num_non_empty_timesteps"]
                   if res["num_non_empty_timesteps"] > 0 else 0.0)
    return res


def combine_vace(seq_results: List[Dict]) -> Dict:
    res = {k: sum(r[k] for r in seq_results)
           for k in ("STDA", "FDA", "VACE_IDs", "VACE_GT_IDs",
                     "num_non_empty_timesteps")}
    return _finalize(res)
