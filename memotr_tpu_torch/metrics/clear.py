"""CLEAR-MOT metrics (Bernardin & Stiefelhagen 2008): MOTA, MOTP, IDSW,
MT/PT/ML, Frag.

Independent numpy implementation matching the evaluation harness the
reference invokes (``TrackEval/trackeval/metrics/clear.py``):
per-frame Hungarian matching that first preserves previous-frame id
assignments (the +1000 bonus) and then maximizes localization; IDSW counted
against the *last ever* matched tracker id per GT track.

The port's own copy of ``memotr_tpu/metrics/clear.py`` (numpy and scipy
only; the port imports nothing of the JAX package).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

_EPS = np.finfo(float).eps
THRESHOLD = 0.5


def clear_sequence(data: Dict) -> Dict[str, float]:
    res = dict.fromkeys(
        ("CLR_TP", "CLR_FN", "CLR_FP", "IDSW", "MT", "PT", "ML", "Frag",
         "MOTP_sum", "CLR_Frames", "num_gt_ids"), 0.0)

    if data["num_pr_dets"] == 0:
        res["CLR_FN"] = data["num_gt_dets"]
        res["ML"] = data["num_gt_ids"]
        res["num_gt_ids"] = data["num_gt_ids"]
        return _finalize(res)
    if data["num_gt_dets"] == 0:
        res["CLR_FP"] = data["num_pr_dets"]
        return _finalize(res)

    n_gt = data["num_gt_ids"]
    gt_count = np.zeros(n_gt)
    gt_matched = np.zeros(n_gt)
    gt_frag = np.zeros(n_gt)
    last_tracker_id = np.full(n_gt, np.nan)      # last-ever match (IDSW)
    prev_tracker_id = np.full(n_gt, np.nan)      # previous-frame match (bonus)

    for gids, pids, sim in zip(data["gt_ids"], data["pr_ids"],
                               data["similarity"]):
        if len(gids) == 0:
            res["CLR_FP"] += len(pids)
            continue
        if len(pids) == 0:
            res["CLR_FN"] += len(gids)
            gt_count[gids] += 1
            continue

        carry = (pids[None, :] == prev_tracker_id[gids][:, None])
        score = 1000.0 * carry + sim
        score[sim < THRESHOLD - _EPS] = 0.0
        rows, cols = linear_sum_assignment(-score)
        ok = score[rows, cols] > _EPS
        rows, cols = rows[ok], cols[ok]
        m_gt, m_pr = gids[rows], pids[cols]

        prev = last_tracker_id[m_gt]
        res["IDSW"] += int(np.sum(~np.isnan(prev) & (m_pr != prev)))

        gt_count[gids] += 1
        gt_matched[m_gt] += 1
        was_untracked = np.isnan(prev_tracker_id)
        last_tracker_id[m_gt] = m_pr
        prev_tracker_id[:] = np.nan
        prev_tracker_id[m_gt] = m_pr
        gt_frag += was_untracked & ~np.isnan(prev_tracker_id)

        n = len(m_gt)
        res["CLR_TP"] += n
        res["CLR_FN"] += len(gids) - n
        res["CLR_FP"] += len(pids) - n
        if n:
            res["MOTP_sum"] += float(sim[rows, cols].sum())

    seen = gt_count > 0
    ratio = gt_matched[seen] / gt_count[seen]
    res["MT"] = float(np.sum(ratio > 0.8))
    res["PT"] = float(np.sum(ratio >= 0.2)) - res["MT"]
    res["ML"] = float(n_gt) - res["MT"] - res["PT"]
    res["Frag"] = float(np.sum(np.maximum(gt_frag[gt_frag > 0] - 1, 0)))
    res["CLR_Frames"] = data["num_timesteps"]
    res["num_gt_ids"] = n_gt
    return _finalize(res)


def _finalize(res: Dict) -> Dict:
    tp, fn, fp = res["CLR_TP"], res["CLR_FN"], res["CLR_FP"]
    n_gt_dets = max(1.0, tp + fn)
    res["MOTA"] = 1.0 - (fn + fp + res["IDSW"]) / n_gt_dets
    res["MODA"] = 1.0 - (fn + fp) / n_gt_dets
    res["MOTP"] = res["MOTP_sum"] / max(1.0, tp)
    # TrackEval clear.py:180: (MOTP_sum - FP - IDSW) / max(1, TP + FN)
    res["sMOTA"] = (res["MOTP_sum"] - fp - res["IDSW"]) / n_gt_dets
    res["CLR_Re"] = tp / n_gt_dets
    res["CLR_Pr"] = tp / max(1.0, tp + fp)
    res["CLR_F1"] = 2 * tp / max(1.0, 2 * tp + fn + fp)
    return res


def combine_clear(seq_results: List[Dict]) -> Dict:
    res = {}
    for k in ("CLR_TP", "CLR_FN", "CLR_FP", "IDSW", "MT", "PT", "ML", "Frag",
              "MOTP_sum", "CLR_Frames", "num_gt_ids"):
        res[k] = sum(r[k] for r in seq_results)
    return _finalize(res)
