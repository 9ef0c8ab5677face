"""Canvas sizes of padded frame batches (counterpart of ``bucket_hw`` in
``memotr_tpu/structures/padded_frame.py``).

Frames are padded to a canvas whose sides are rounded up to a bucket
multiple; a boolean mask marks the padding (True = pad).  Few canvas sizes
mean few distinct shapes for the train step.
"""
from __future__ import annotations


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_hw(h: int, w: int, multiple: int = 128) -> tuple[int, int]:
    """Round (h, w) up to multiples of ``multiple``."""
    return round_up(h, multiple), round_up(w, multiple)
