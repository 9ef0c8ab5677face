"""Base clip dataset with the sampling curriculum (counterpart of
``memotr_tpu/data/mot.py``).

Per-epoch clip-length curriculum (``SAMPLE_STEPS`` / ``SAMPLE_LENGTHS``),
``random_interval`` frame sampling with a per-stage interval cap, and
per-video id offsets that make identities unique across videos.
``get(item, rng)`` draws from ``rng`` (``transforms.HostRNG``);
``dataset[item]`` draws from the process-wide generators, as the JAX
package's datasets do.
"""
from __future__ import annotations

from math import floor
from typing import Dict, List, Tuple

import numpy as np

from .transforms import GLOBAL_RNG, HostRNG

ID_OFFSET_PER_VIDEO = 100000


def open_rgb(path: str):
    import PIL.Image
    return PIL.Image.open(path).convert("RGB")


def frame_info(rows, id_offset: int = 0) -> Dict:
    """GT rows ``(obj_id, label, x, y, w, h)`` in pixels -> a frame's info:
    boxes (N, 4) xyxy float32, ids (with ``id_offset``), labels, areas."""
    if rows:
        arr = np.asarray([r[2:] for r in rows], np.float32)   # xywh
        return {"boxes": np.concatenate([arr[:, :2], arr[:, :2] + arr[:, 2:]],
                                        -1),
                "ids": np.asarray([r[0] + id_offset for r in rows], np.int64),
                "labels": np.asarray([r[1] for r in rows], np.int64),
                "areas": arr[:, 2] * arr[:, 3]}
    return {"boxes": np.zeros((0, 4), np.float32),
            "ids": np.zeros((0,), np.int64),
            "labels": np.zeros((0,), np.int64),
            "areas": np.zeros((0,), np.float32)}


def interval_idxs(rng: HostRNG, begin: int, t_max: int, length: int,
                  max_step: int) -> List[int]:
    """``random_interval`` sampling: ``length`` frames from ``begin`` a
    drawn interval apart (at most ``max_step``, and fitting by ``t_max``)."""
    remain = t_max - begin
    max_interval = floor(remain / max(length - 1, 1))
    interval = min(rng.py.randint(1, max_step), max(max_interval, 1))
    return [begin + interval * i for i in range(length)]


class ClipDataset:
    """Samples fixed-length clips of frames with their GTs.

    Subclasses fill ``self.gts[vid][t] -> [(obj_id, label, x, y, w, h)]``
    (pixel xywh) and implement ``frame_path(vid, t)``."""

    def __init__(self, config: dict, transform):
        self.config = config
        self.transform = transform
        self.gts: Dict[str, Dict[int, list]] = {}
        self.vid_idx: Dict[str, int] = {}
        self.sample_steps: List[int] = list(config["SAMPLE_STEPS"])
        self.sample_lengths: List[int] = list(config["SAMPLE_LENGTHS"])
        self.sample_modes: List[str] = list(config["SAMPLE_MODES"])
        self.sample_intervals: List[int] = list(config["SAMPLE_INTERVALS"])
        self.sample_length = self.sample_lengths[0]
        self.sample_mode = self.sample_modes[0]
        self.sample_interval = self.sample_intervals[0]
        self.sample_begin_frames: List[Tuple[str, int]] = []
        self.sample_vid_tmax: Dict[str, int] = {}

    def frame_path(self, vid: str, t: int) -> str:
        raise NotImplementedError

    def register_video(self, vid: str):
        if vid not in self.vid_idx:
            self.vid_idx[vid] = len(self.vid_idx)
            self.gts.setdefault(vid, {})

    def set_stage(self, epoch: int):
        """The curriculum stage's clip length, mode and interval cap."""
        stage = sum(1 for step in self.sample_steps if epoch >= step)

        def pick(lst):
            return lst[min(len(lst) - 1, stage)]
        self.sample_length = pick(self.sample_lengths)
        self.sample_mode = pick(self.sample_modes)
        self.sample_interval = pick(self.sample_intervals)
        self.sample_begin_frames = []
        self.sample_vid_tmax = {}

    def set_epoch(self, epoch: int):
        self.set_stage(epoch)
        for vid in self.vid_idx:
            ts = self.gts[vid].keys()
            if not ts:
                continue
            t_min, t_max = min(ts), max(ts)
            self.sample_vid_tmax[vid] = t_max
            for t in range(t_min, t_max - (self.sample_length - 1) + 1):
                self.sample_begin_frames.append((vid, t))

    def sample_frame_idxs(self, vid: str, begin: int,
                          rng: HostRNG = GLOBAL_RNG) -> List[int]:
        if self.sample_mode != "random_interval":
            raise ValueError(f"Unsupported sample mode {self.sample_mode}")
        if self.sample_length == 1:
            return [begin]
        return interval_idxs(rng, begin, self.sample_vid_tmax[vid],
                             self.sample_length, self.sample_interval)

    def load_frame(self, vid: str, t: int):
        info = frame_info(self.gts[vid].get(t, []),
                          self.vid_idx[vid] * ID_OFFSET_PER_VIDEO)
        info["frame_idx"] = t
        return open_rgb(self.frame_path(vid, t)), info

    def __len__(self):
        return len(self.sample_begin_frames)

    def get(self, item: int, rng: HostRNG = GLOBAL_RNG) -> Dict:
        """Clip ``item``: ``{"imgs": [T frames], "infos": [T dicts]}``."""
        vid, begin = self.sample_begin_frames[item]
        idxs = self.sample_frame_idxs(vid, begin, rng)
        imgs, infos = zip(*[self.load_frame(vid, t) for t in idxs])
        imgs, infos = list(imgs), list(infos)
        if self.transform is not None:
            imgs, infos = self.transform(imgs, infos, rng)
        return {"imgs": list(imgs), "infos": list(infos)}

    def __getitem__(self, item: int) -> Dict:
        return self.get(item)
