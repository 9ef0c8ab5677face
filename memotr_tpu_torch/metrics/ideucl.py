"""IDEucl metric: identity-preserved fraction of GT trajectory path length.

Independent numpy implementation matching the harness the reference bundles
(``TrackEval/trackeval/metrics/ideucl.py``): per (gt, pred)
pair, sum the euclidean path length of the GT centroids over frames where the
pair overlaps (IoU>=0.5); a max-distance assignment picks one pred per GT;
IDEucl = covered length / total GT length.

``data`` needs an extra "gt_dets" field: per-frame (N, 4) xywh GT boxes.

The port's own copy of ``memotr_tpu/metrics/ideucl.py`` (numpy and scipy
only; the port imports nothing of the JAX package).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

THRESHOLD = 0.5


def _centroids(boxes_xywh: np.ndarray) -> np.ndarray:
    """(N, 4) xywh -> (N, 2) centroids in (y, x) order (TrackEval flips)."""
    cx = boxes_xywh[:, 0] + boxes_xywh[:, 2] / 2
    cy = boxes_xywh[:, 1] + boxes_xywh[:, 3] / 2
    return np.stack([cy, cx], axis=1)


def ideucl_sequence(data: Dict) -> Dict[str, float]:
    if data["num_pr_dets"] == 0 or data["num_gt_dets"] == 0:
        return {"IDEucl": 0.0, "_hyp_len": 0.0, "_gt_len": 0.0}

    pair_cents = defaultdict(list)
    gt_cents = defaultdict(list)
    for gids, pids, sim, gdets in zip(data["gt_ids"], data["pr_ids"],
                                      data["similarity"], data["gt_dets"]):
        cents = _centroids(np.asarray(gdets, np.float64).reshape(-1, 4))
        for i, gid in enumerate(gids):
            gt_cents[int(gid)].append(cents[i])
        gi, pi = np.nonzero(sim >= THRESHOLD)
        for g, p_ in zip(gi, pi):
            pair_cents[(int(gids[g]), int(pids[p_]))].append(cents[g])

    def path_len(pts):
        arr = np.asarray(pts)
        if len(arr) < 2:
            return 0.0
        return float(np.linalg.norm(np.diff(arr, axis=0), axis=1).sum())

    pair_dist = {k: path_len(v) for k, v in pair_cents.items()}
    gt_dist = {k: path_len(v) for k, v in gt_cents.items()}

    uniq_g = sorted({k[0] for k in pair_dist})
    uniq_p = sorted({k[1] for k in pair_dist})
    covered = dict.fromkeys(gt_dist, 0.0)
    if uniq_g and uniq_p:
        mat = np.zeros((len(uniq_g), len(uniq_p)))
        for (g, p_), dist in pair_dist.items():
            mat[uniq_g.index(g), uniq_p.index(p_)] = dist
        rows, cols = linear_sum_assignment(np.max(mat) - mat)
        for r, c in zip(rows, cols):
            covered[uniq_g[r]] = mat[r, c]

    hyp_len = float(sum(covered.values()))
    gt_len = float(sum(gt_dist.values()))
    return {"IDEucl": hyp_len / gt_len if gt_len > 0 else 0.0,
            "_hyp_len": hyp_len, "_gt_len": gt_len}


def combine_ideucl(seq_results: List[Dict]) -> Dict:
    hyp = sum(r["_hyp_len"] for r in seq_results)
    gt = sum(r["_gt_len"] for r in seq_results)
    return {"IDEucl": hyp / gt if gt > 0 else 0.0, "_hyp_len": hyp,
            "_gt_len": gt}
