"""Per-frame sequence data preparation for the tracking metrics.

Equivalent role to TrackEval's dataset classes
(``TrackEval/trackeval/datasets/mot_challenge_2d_box.py``):
turn raw per-frame (id, box) lists into contiguous-id arrays plus per-frame
IoU similarity matrices.  Our implementation is an independent numpy
re-derivation of the published metric definitions — only the algorithms are
shared with TrackEval, not the code.

The port's own copy of ``memotr_tpu/metrics/similarity.py`` (numpy and scipy
only; the port imports nothing of the JAX package).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def iou_xywh(gt: np.ndarray, pr: np.ndarray) -> np.ndarray:
    """IoU between (N, 4) and (M, 4) boxes in xywh -> (N, M)."""
    if len(gt) == 0 or len(pr) == 0:
        return np.zeros((len(gt), len(pr)))
    g = np.concatenate([gt[:, :2], gt[:, :2] + gt[:, 2:]], axis=1)
    p = np.concatenate([pr[:, :2], pr[:, :2] + pr[:, 2:]], axis=1)
    lt = np.maximum(g[:, None, :2], p[None, :, :2])
    rb = np.minimum(g[:, None, 2:], p[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_g = gt[:, 2] * gt[:, 3]
    area_p = pr[:, 2] * pr[:, 3]
    union = area_g[:, None] + area_p[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def build_sequence_data(gt_frames: Sequence[Tuple[np.ndarray, np.ndarray]],
                        pr_frames: Sequence[Tuple[np.ndarray, np.ndarray]]
                        ) -> Dict:
    """Build the canonical per-sequence eval structure.

    gt_frames / pr_frames: per-timestep (ids (N,), boxes (N,4) xywh).
    Remaps raw ids to contiguous [0, num_ids) and computes IoU similarity.
    """
    assert len(gt_frames) == len(pr_frames)
    gt_id_map: Dict[int, int] = {}
    pr_id_map: Dict[int, int] = {}
    gt_ids_list: List[np.ndarray] = []
    pr_ids_list: List[np.ndarray] = []
    gt_dets_list: List[np.ndarray] = []
    sims: List[np.ndarray] = []
    num_gt_dets = num_pr_dets = 0
    for (gids, gboxes), (pids, pboxes) in zip(gt_frames, pr_frames):
        for i in np.asarray(gids).tolist():
            gt_id_map.setdefault(int(i), len(gt_id_map))
        for i in np.asarray(pids).tolist():
            pr_id_map.setdefault(int(i), len(pr_id_map))
        gt_ids_list.append(np.asarray(
            [gt_id_map[int(i)] for i in np.asarray(gids)], np.int32))
        pr_ids_list.append(np.asarray(
            [pr_id_map[int(i)] for i in np.asarray(pids)], np.int32))
        gboxes_arr = np.asarray(gboxes, np.float64).reshape(-1, 4)
        gt_dets_list.append(gboxes_arr)
        sims.append(iou_xywh(gboxes_arr,
                             np.asarray(pboxes, np.float64).reshape(-1, 4)))
        num_gt_dets += len(gids)
        num_pr_dets += len(pids)
    return {
        "gt_ids": gt_ids_list,
        "pr_ids": pr_ids_list,
        "gt_dets": gt_dets_list,
        "similarity": sims,
        "num_gt_ids": len(gt_id_map),
        "num_pr_ids": len(pr_id_map),
        "num_gt_dets": num_gt_dets,
        "num_pr_dets": num_pr_dets,
        "num_timesteps": len(gt_frames),
    }
