"""Post-hoc linear motion extrapolation, ``USE_MOTION`` (counterpart of
``memotr_tpu/models/motion.py``; off in every shipped config).

Each track id keeps a ring buffer of its last ``MOTION_MAX_LENGTH`` observed
boxes.  While a track is missing, its box is extrapolated by the mean
per-frame box delta of that record times the miss length, scaled by
``MOTION_LAMBDA``; a record shorter than ``MOTION_MIN_LENGTH`` gives no
extrapolation.  numpy on the host: it touches only the few disappeared
tracks of a frame (``engine/submit.py`` ``Submitter._apply_motion``).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np


class Motion:
    def __init__(self, min_record_length: int = 3, max_record_length: int = 5):
        self.min_record_length = min_record_length
        self.boxes: deque = deque(maxlen=max_record_length)

    def add_box(self, box: np.ndarray):
        self.boxes.append(np.asarray(box, np.float32))

    def clear(self):
        self.boxes.clear()

    def __len__(self):
        return len(self.boxes)

    def get_box_delta(self, miss_length: int) -> np.ndarray:
        """Mean per-frame delta of the record times ``miss_length`` (zeros
        below two boxes)."""
        if len(self.boxes) < 2:
            return np.zeros(4, np.float32)
        arr = np.stack(list(self.boxes))
        deltas = arr[1:] - arr[:-1]
        return deltas.mean(axis=0) * miss_length


class MotionBank:
    """Per-track-id motion records of one streamed sequence."""

    def __init__(self, min_record_length: int = 3, max_record_length: int = 5):
        self.min_len = min_record_length
        self.max_len = max_record_length
        self.records: Dict[int, Motion] = {}

    def observe(self, track_id: int, box: np.ndarray, reappeared: bool):
        """Add a sighting; a track seen again after missing frames starts
        a new record."""
        m = self.records.setdefault(
            int(track_id), Motion(self.min_len, self.max_len))
        if reappeared:
            m.clear()
        m.add_box(box)

    def extrapolate(self, track_id: int, last_box: np.ndarray,
                    miss_length: int, lam: float) -> Optional[np.ndarray]:
        """The extrapolated cxcywh box of a track missing for
        ``miss_length`` frames, or None when its record is too short."""
        m = self.records.get(int(track_id))
        if m is None or len(m) < m.min_record_length:
            return None
        return np.asarray(last_box, np.float32) + lam * m.get_box_delta(miss_length)
