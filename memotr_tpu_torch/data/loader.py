"""Threaded clip loader, epoch order and fixed-shape collation
(counterpart of ``memotr_tpu/data/loader.py``).

Collation pads every frame of a batch onto one bucketed canvas with a
padding mask, and the GTs of every frame to ``max_gts`` rows with a
validity mask (overflow keeps the largest boxes).  ``DataLoader`` runs a
pool of threads that load, augment and collate batches ahead of the
training loop and yields them in a fixed order.  It is a thread pool and
not ``torch.utils.data.DataLoader``: worker processes would reseed
``random``, and the clips would no longer be the JAX package's.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np

from ..structures.padded_frame import bucket_hw
from .transforms import GLOBAL_RNG, seeded_rng


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


class _WorkerFailure:
    def __init__(self, exc: BaseException):
        self.exc = exc


PREFETCH = 4                    # batches loaded ahead of the consumer


class DataLoader:
    """Thread-pool prefetching loader with a deterministic batch order.

    Each epoch takes ``epoch_indices`` (a permutation seeded with
    ``seed + epoch``, strided over ``world_size`` ranks), cut into batches
    of ``batch_size`` clips (the last partial batch is dropped);
    ``num_workers`` threads load and collate batches, at most ``PREFETCH``
    ahead, and batches are yielded in order.  ``fixed_canvas=(H, W)`` pads
    every batch to one canvas.  ``set_epoch`` is forwarded to the dataset
    (its curriculum).

    Draws: with one worker every clip draws from the process-wide
    ``random`` and ``np.random`` in batch order, as the JAX package's loader
    does, so the same seed gives the same batches.  With more workers the
    JAX loader's draws interleave as its threads happen to run; here each
    batch draws from generators of its own, seeded from (``seed``,
    ``rank``, epoch, batch index), so the batches are the same from run to
    run at any worker count above one.  A worker's exception is raised in
    the consumer; leaving the loop early stops the workers."""

    def __init__(self, dataset, batch_size: int, max_gts: int,
                 num_workers: int = 4, shuffle: bool = True, seed: int = 42,
                 rank: int = 0, world_size: int = 1,
                 bucket_multiple: int = 128, fixed_canvas=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_gts = max_gts
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.bucket_multiple = bucket_multiple
        self.fixed_canvas = fixed_canvas
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(self.dataset)
        if self.world_size > 1:
            n = n // self.world_size
        return n // self.batch_size

    def load_batch(self, k: int, idxs) -> Dict[str, np.ndarray]:
        rng = GLOBAL_RNG if self.num_workers == 1 else seeded_rng(
            self.seed, self.rank, self.epoch, k)
        items = [self.dataset.get(int(j), rng) for j in idxs]
        return collate_clips(items, self.max_gts, self.bucket_multiple,
                             self.fixed_canvas)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idxs = epoch_indices(len(self.dataset), shuffle=self.shuffle,
                             seed=self.seed, epoch=self.epoch,
                             rank=self.rank, world_size=self.world_size)
        batches = [idxs[k * self.batch_size:(k + 1) * self.batch_size]
                   for k in range(len(idxs) // self.batch_size)]
        out_q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        lock = threading.Lock()
        next_batch = [0]

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                while not stop.is_set():
                    with lock:
                        k = next_batch[0]
                        if k >= len(batches):
                            return
                        next_batch[0] += 1
                    if not put((k, self.load_batch(k, batches[k]))):
                        return
            except BaseException as e:    # noqa: BLE001 - raised below
                put((-1, _WorkerFailure(e)))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for th in threads:
            th.start()
        try:
            pending: Dict[int, Dict] = {}
            for want in range(len(batches)):
                while want not in pending:
                    k, batch = out_q.get()
                    if isinstance(batch, _WorkerFailure):
                        raise RuntimeError("data loader worker failed") \
                            from batch.exc
                    pending[k] = batch
                yield pending.pop(want)
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=5.0)
