"""Epoch order and fixed-shape clip collation (counterpart of
``epoch_indices`` and ``collate_clips`` in ``memotr_tpu/data/loader.py``).

numpy only.  Collation pads every frame of a batch onto one bucketed canvas
with a padding mask, and the GTs of every frame to ``max_gts`` rows with a
validity mask (overflow keeps the largest boxes).  The threaded loader and
the datasets come with the data slice.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..structures.padded_frame import bucket_hw


def epoch_indices(n: int, *, shuffle: bool, seed: int, epoch: int,
                  rank: int = 0, world_size: int = 1,
                  drop_last: bool = True) -> np.ndarray:
    """Seeded permutation, strided across ranks (DistributedSampler order)."""
    order = (np.random.default_rng(seed + epoch).permutation(n)
             if shuffle else np.arange(n))
    if world_size > 1:
        if drop_last:
            order = order[: (n // world_size) * world_size]
        else:
            pad = (-len(order)) % world_size
            order = np.concatenate([order, order[:pad]])
        order = order[rank::world_size]
    return order


def collate_clips(batch: List[Dict], max_gts: int,
                  bucket_multiple: int = 128,
                  fixed_canvas=None) -> Dict[str, np.ndarray]:
    """List of ``{"imgs": [T x (H, W, 3) float32], "infos": [T x dict]}``
    (infos hold "boxes" normalized cxcywh, "ids", "labels", "areas") ->
    images (B, T, H, W, 3), mask (B, T, H, W), gt_boxes (B, T, G, 4),
    gt_ids / gt_labels (B, T, G) int32, gt_mask (B, T, G) and the count of
    GTs dropped over ``max_gts``.  ``fixed_canvas=(H, W)`` pads every batch
    to one canvas instead of the bucketed largest frame."""
    b = len(batch)
    t = len(batch[0]["imgs"])
    hs = [im.shape[0] for item in batch for im in item["imgs"]]
    ws = [im.shape[1] for item in batch for im in item["imgs"]]
    if fixed_canvas is not None:
        H, W = fixed_canvas
        assert max(hs) <= H and max(ws) <= W, \
            f"fixed canvas {fixed_canvas} smaller than batch " \
            f"({max(hs)}x{max(ws)})"
    else:
        H, W = bucket_hw(max(hs), max(ws), bucket_multiple)

    images = np.zeros((b, t, H, W, 3), np.float32)
    mask = np.ones((b, t, H, W), bool)
    gt_boxes = np.zeros((b, t, max_gts, 4), np.float32)
    gt_ids = np.full((b, t, max_gts), -1, np.int32)
    gt_labels = np.zeros((b, t, max_gts), np.int32)
    gt_mask = np.zeros((b, t, max_gts), bool)

    gt_dropped = 0
    for i, item in enumerate(batch):
        for f, (img, info) in enumerate(zip(item["imgs"], item["infos"])):
            h, w = img.shape[:2]
            images[i, f, :h, :w] = img
            mask[i, f, :h, :w] = False
            boxes = np.asarray(info["boxes"])
            ids = np.asarray(info["ids"])
            labels = np.asarray(info["labels"])
            n = len(boxes)
            if n > max_gts:
                gt_dropped += n - max_gts
                keep = np.argsort(-np.asarray(info["areas"]))[:max_gts]
                boxes, ids, labels = boxes[keep], ids[keep], labels[keep]
                n = max_gts
            if n > 0:
                gt_boxes[i, f, :n] = boxes
                gt_ids[i, f, :n] = ids
                gt_labels[i, f, :n] = labels
                gt_mask[i, f, :n] = True
    return {"images": images, "mask": mask, "gt_boxes": gt_boxes,
            "gt_ids": gt_ids, "gt_labels": gt_labels, "gt_mask": gt_mask,
            "gt_dropped": gt_dropped}
