"""HOTA metric (Luiten et al., IJCV 2021).

Independent numpy implementation of the published HOTA definition, matching
the behavior of the evaluation harness the reference invokes
(``TrackEval/trackeval/metrics/hota.py``): per-alpha TP/FN/FP
with the Jaccard global-alignment tie-breaking match, association scores
averaged over TPs, and geometric-mean HOTA = sqrt(DetA * AssA).

The port's own copy of ``memotr_tpu/metrics/hota.py`` (numpy and scipy
only; the port imports nothing of the JAX package).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

ALPHAS = np.arange(0.05, 0.99, 0.05)
_EPS = np.finfo(float).eps


def hota_sequence(data: Dict) -> Dict[str, np.ndarray]:
    na = len(ALPHAS)
    res = {k: np.zeros(na) for k in
           ("HOTA_TP", "HOTA_FN", "HOTA_FP", "LocA_sum", "AssA", "AssRe",
            "AssPr")}

    if data["num_pr_dets"] == 0:
        res["HOTA_FN"] += data["num_gt_dets"]
        return _finalize(res)
    if data["num_gt_dets"] == 0:
        res["HOTA_FP"] += data["num_pr_dets"]
        return _finalize(res)

    n_gt, n_pr = data["num_gt_ids"], data["num_pr_ids"]
    potential = np.zeros((n_gt, n_pr))
    gt_count = np.zeros((n_gt, 1))
    pr_count = np.zeros((1, n_pr))

    # pass 1: soft global alignment accumulation
    for gids, pids, sim in zip(data["gt_ids"], data["pr_ids"],
                               data["similarity"]):
        denom = sim.sum(0)[None, :] + sim.sum(1)[:, None] - sim
        soft = np.divide(sim, denom, out=np.zeros_like(sim),
                         where=denom > _EPS)
        potential[gids[:, None], pids[None, :]] += soft
        gt_count[gids] += 1
        pr_count[0, pids] += 1

    global_alignment = potential / (gt_count + pr_count - potential)
    match_counts = [np.zeros((n_gt, n_pr)) for _ in range(na)]

    # pass 2: per-frame optimal matching, per-alpha thresholding
    for gids, pids, sim in zip(data["gt_ids"], data["pr_ids"],
                               data["similarity"]):
        if len(gids) == 0:
            res["HOTA_FP"] += len(pids)
            continue
        if len(pids) == 0:
            res["HOTA_FN"] += len(gids)
            continue
        score = global_alignment[gids[:, None], pids[None, :]] * sim
        rows, cols = linear_sum_assignment(-score)
        matched_sim = sim[rows, cols]
        for a, alpha in enumerate(ALPHAS):
            ok = matched_sim >= alpha - _EPS
            n = int(ok.sum())
            res["HOTA_TP"][a] += n
            res["HOTA_FN"][a] += len(gids) - n
            res["HOTA_FP"][a] += len(pids) - n
            if n:
                res["LocA_sum"][a] += matched_sim[ok].sum()
                match_counts[a][gids[rows[ok]], pids[cols[ok]]] += 1

    gt_c = gt_count
    pr_c = pr_count
    for a in range(na):
        mc = match_counts[a]
        ass_a = mc / np.maximum(1, gt_c + pr_c - mc)
        res["AssA"][a] = (mc * ass_a).sum() / max(1.0, res["HOTA_TP"][a])
        res["AssRe"][a] = (mc * (mc / np.maximum(1, gt_c))).sum() \
            / max(1.0, res["HOTA_TP"][a])
        res["AssPr"][a] = (mc * (mc / np.maximum(1, pr_c))).sum() \
            / max(1.0, res["HOTA_TP"][a])
    return _finalize(res)


def _finalize(res: Dict) -> Dict:
    tp, fn, fp = res["HOTA_TP"], res["HOTA_FN"], res["HOTA_FP"]
    res["DetRe"] = tp / np.maximum(1, tp + fn)
    res["DetPr"] = tp / np.maximum(1, tp + fp)
    res["DetA"] = tp / np.maximum(1, tp + fn + fp)
    res["LocA"] = np.maximum(1e-10, res["LocA_sum"]) / np.maximum(1e-10, tp)
    res["HOTA"] = np.sqrt(res["DetA"] * res["AssA"])
    return res


def combine_hota(seq_results: List[Dict]) -> Dict:
    """Cross-sequence combination: sum counts, TP-weighted association
    averages (hota.py:119-129)."""
    res = {}
    for k in ("HOTA_TP", "HOTA_FN", "HOTA_FP", "LocA_sum"):
        res[k] = sum(r[k] for r in seq_results)
    tp_total = np.maximum(1e-10, res["HOTA_TP"])
    for k in ("AssA", "AssRe", "AssPr"):
        res[k] = sum(r[k] * r["HOTA_TP"] for r in seq_results) / tp_total
    return _finalize(res)


def summarize(res: Dict) -> Dict[str, float]:
    """Mean over the alpha sweep, scaled to percent (TrackEval convention)."""
    keys = ("HOTA", "DetA", "AssA", "DetRe", "DetPr", "AssRe", "AssPr", "LocA")
    return {k: float(np.mean(res[k]) * 100) for k in keys}
