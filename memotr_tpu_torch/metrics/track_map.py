"""TrackMAP — track-level average precision (TAO-style).

Parity target: TrackEval's ``TrackMAP``
(``TrackEval/trackeval/metrics/track_map.py:9-316``):
whole-track IoU (per-frame intersections over per-frame unions summed along
time), greedy score-ordered matching per IoU threshold, COCO-style
101-point interpolated AP, evaluated for the full track set plus area- and
time-range subsets via ignore masks.

Deliberately-replicated reference quirks (needed for numerical identity):
- a ground-truth track is considered "already matched" via ``gt_m > 0`` on
  the stored *tracker id value* — a tracker track with id 0 never blocks
  re-matching (track_map.py:127);
- range ignore masks use eps-padded inclusive bounds (track_map.py:333-340).

Track IoU uses the identity ``U = A_dt + A_gt - I`` (per-frame union summed
over the union of frames equals total areas minus total common-frame
intersection), so only common frames need pairwise work.

The port's own copy of ``memotr_tpu/metrics/track_map.py`` (numpy and scipy
only; the port imports nothing of the JAX package).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 0.96, 0.05)
RECALL_THRESHOLDS = np.linspace(0.0, 1.0, 101, endpoint=True)
AREA_RANGES = ((0.0, 32.0 ** 2), (32.0 ** 2, 96.0 ** 2), (96.0 ** 2, 1e10))
AREA_LABELS = ("area_s", "area_m", "area_l")
TIME_RANGES = ((0, 3), (3, 10), (10, 1e5))
TIME_LABELS = ("time_s", "time_m", "time_l")
LABELS = ("all",) + AREA_LABELS + TIME_LABELS


def build_track_data(gt_frames, pr_frames,
                     pr_scores: Optional[Sequence] = None) -> Dict:
    """Per-frame (ids, boxes xywh) lists -> track-level structure.

    ``pr_scores``: per-frame arrays of detection confidences (optional;
    a track's score is its mean confidence, else 1.0).
    """
    def collect(frames, scores_seq=None):
        tracks: Dict[int, Dict[int, np.ndarray]] = {}
        scores: Dict[int, List[float]] = {}
        for t, (ids, boxes) in enumerate(frames):
            sc = None if scores_seq is None else scores_seq[t]
            for k, tid in enumerate(np.asarray(ids).tolist()):
                tracks.setdefault(int(tid), {})[t] = \
                    np.asarray(boxes[k], np.float64)
                scores.setdefault(int(tid), []).append(
                    1.0 if sc is None else float(sc[k]))
        ids_sorted = sorted(tracks)
        return (ids_sorted, [tracks[i] for i in ids_sorted],
                [float(np.mean(scores[i])) for i in ids_sorted])

    gt_ids, gt_tracks, _ = collect(gt_frames)
    dt_ids, dt_tracks, dt_scores = collect(pr_frames, pr_scores)

    def areas(tracks):
        return [float(np.mean([b[2] * b[3] for b in tr.values()]))
                if tr else 0.0 for tr in tracks]

    return {
        "gt_track_ids": gt_ids, "dt_track_ids": dt_ids,
        "gt_tracks": gt_tracks, "dt_tracks": dt_tracks,
        "dt_track_scores": np.asarray(dt_scores, np.float64),
        "gt_track_areas": areas(gt_tracks),
        "dt_track_areas": areas(dt_tracks),
        "gt_track_lengths": [len(tr) for tr in gt_tracks],
        "dt_track_lengths": [len(tr) for tr in dt_tracks],
    }


def _track_iou(dt: Dict[int, np.ndarray], gt: Dict[int, np.ndarray]) -> float:
    """Whole-track IoU for xywh boxes (track_map.py:349-398)."""
    a_dt = sum(float(b[2] * b[3]) for b in dt.values())
    a_gt = sum(float(b[2] * b[3]) for b in gt.values())
    inter = 0.0
    for t in dt.keys() & gt.keys():
        d, g = dt[t], gt[t]
        w = max(min(d[0] + d[2], g[0] + g[2]) - max(d[0], g[0]), 0.0)
        h = max(min(d[1] + d[3], g[1] + g[3]) - max(d[1], g[1]), 0.0)
        inter += w * h
    union = a_dt + a_gt - inter
    return inter / union if union > 0 else 0.0


def _ignore_masks(n: int, lengths, areas) -> List[np.ndarray]:
    """All-tracks mask + per-area-range + per-time-range masks
    (track_map.py:320-346); 1 = ignore."""
    eps = np.finfo("float").eps
    masks = [np.zeros(n, np.int64)]
    for lo, hi in AREA_RANGES:
        masks.append(np.asarray(
            [0 if lo - eps <= a <= hi + eps else 1 for a in areas],
            np.int64))
    for lo, hi in TIME_RANGES:
        masks.append(np.asarray(
            [0 if lo - eps <= ln <= hi + eps else 1 for ln in lengths],
            np.int64))
    return masks


def track_map_sequence(data: Dict) -> List[Optional[Dict]]:
    """Greedy per-threshold track matching for one sequence
    (track_map.py:63-168).  Returns one match record per ignore mask."""
    gt_ids = list(data["gt_track_ids"])
    dt_ids = list(data["dt_track_ids"])
    if not gt_ids and not dt_ids:
        return [None] * len(LABELS)

    gt_ig_masks = _ignore_masks(len(gt_ids), data["gt_track_lengths"],
                                data["gt_track_areas"])
    dt_ig_masks = _ignore_masks(len(dt_ids), data["dt_track_lengths"],
                                data["dt_track_areas"])
    ious = np.zeros((len(dt_ids), len(gt_ids)))
    for i, dtr in enumerate(data["dt_tracks"]):
        for j, gtr in enumerate(data["gt_tracks"]):
            ious[i, j] = _track_iou(dtr, gtr)

    num_thrs = len(IOU_THRESHOLDS)
    eps = np.finfo("float").eps
    out: List[Optional[Dict]] = []
    for mask_idx in range(len(LABELS)):
        gt_ig_mask = gt_ig_masks[mask_idx]
        gt_order = np.argsort(gt_ig_mask, kind="mergesort")  # ignores last
        gt_ids_sorted = [gt_ids[i] for i in gt_order]
        ious_sorted = ious[:, gt_order] if len(ious) else ious
        gt_ig = gt_ig_mask[gt_order]

        gt_m = np.full((num_thrs, len(gt_ids)), -1.0)
        dt_m = np.full((num_thrs, len(dt_ids)), -1.0)
        dt_ig = np.zeros((num_thrs, len(dt_ids)))

        for ti, thr in enumerate(IOU_THRESHOLDS):
            if len(ious_sorted) == 0:
                break
            for di in range(len(dt_ids)):
                best = min(thr, 1 - 1e-10)
                m = -1
                for gi in range(len(gt_ids_sorted)):
                    if gt_m[ti, gi] > 0:     # quirk: id-0 match never blocks
                        continue
                    if m > -1 and gt_ig[m] == 0 and gt_ig[gi] == 1:
                        break
                    if ious_sorted[di, gi] < best - eps:
                        continue
                    best = ious_sorted[di, gi]
                    m = gi
                if m == -1:
                    continue
                dt_ig[ti, di] = gt_ig[m]
                dt_m[ti, di] = gt_ids_sorted[m]
                gt_m[ti, m] = dt_ids[di]

        dt_ig_mask = np.repeat(
            np.asarray(dt_ig_masks[mask_idx]).reshape(1, -1), num_thrs, 0)
        dt_ig = np.logical_or(dt_ig, np.logical_and(dt_m == -1, dt_ig_mask))
        out.append({
            "dt_matches": dt_m,
            "dt_scores": np.asarray(data["dt_track_scores"], np.float64),
            "gt_ignore": gt_ig,
            "dt_ignore": dt_ig,
        })
    return out


def combine_track_map(seq_results: Sequence[List[Optional[Dict]]]) -> Dict:
    """Cross-sequence COCO-style PR curves + AP/AR per label
    (track_map.py:171-276)."""
    num_thrs = len(IOU_THRESHOLDS)
    num_recalls = len(RECALL_THRESHOLDS)
    precision = -np.ones((num_thrs, num_recalls, len(LABELS)))
    recall = -np.ones((num_thrs, len(LABELS)))

    for ig_idx in range(len(LABELS)):
        results = [r[ig_idx] for r in seq_results if r[ig_idx] is not None]
        if not results:
            continue
        dt_scores = np.concatenate([r["dt_scores"] for r in results])
        order = np.argsort(-dt_scores, kind="mergesort")
        dt_m = np.concatenate([r["dt_matches"] for r in results],
                              axis=1)[:, order]
        dt_ig = np.concatenate([r["dt_ignore"] for r in results],
                               axis=1)[:, order]
        gt_ig = np.concatenate([r["gt_ignore"] for r in results])
        num_gt = int(np.count_nonzero(gt_ig == 0))
        if num_gt == 0:
            continue

        tps = np.logical_and(dt_m != -1, np.logical_not(dt_ig))
        fps = np.logical_and(dt_m == -1, np.logical_not(dt_ig))
        tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
        fp_sum = np.cumsum(fps, axis=1).astype(np.float64)

        for ti, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
            rc = tp / num_gt
            recall[ti, ig_idx] = rc[-1] if len(tp) else 0
            pr = (tp / (fp + tp + np.spacing(1))).tolist()
            for i in range(len(pr) - 1, 0, -1):    # monotone envelope
                if pr[i] > pr[i - 1]:
                    pr[i - 1] = pr[i]
            idxs = np.searchsorted(rc, RECALL_THRESHOLDS, side="left")
            pr_at = [0.0] * num_recalls
            try:
                for k, pi in enumerate(idxs):
                    pr_at[k] = pr[pi]
            except IndexError:
                pass
            precision[ti, :, ig_idx] = pr_at

    res = {"precision": precision, "recall": recall}
    for li, lbl in enumerate(LABELS):
        ap = np.zeros(num_thrs)
        ar = np.zeros(num_thrs)
        for ti in range(num_thrs):
            p = precision[ti, :, li]
            ap[ti] = np.mean(p[p > -1]) if len(p[p > -1]) else -1
            ar[ti] = recall[ti, li]
        res[f"AP_{lbl}"] = ap
        res[f"AR_{lbl}"] = ar
    return res


def summarize(combined: Dict) -> Dict[str, float]:
    """Scalar summary: mean over IoU thresholds of defined (> -1) entries."""
    out = {}
    for lbl in LABELS:
        for f in ("AP", "AR"):
            v = combined[f"{f}_{lbl}"]
            valid = v[v > -1]
            out[f"{f}_{lbl}"] = float(np.mean(valid)) if len(valid) else -1.0
    return out
