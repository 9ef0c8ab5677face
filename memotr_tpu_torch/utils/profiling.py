"""Tracing and profiling hooks (counterpart of
``memotr_tpu/utils/profiling.py``).

- ``trace(logdir)``: ``torch.profiler`` over a region (host and, on a
  card, CUDA activity), written to ``logdir`` as a Chrome trace
  (``trace.json``, viewable in Perfetto); the profile is returned for
  ``key_averages()``;
- ``annotate(name)``: a named range inside a trace (``record_function``);
- ``device_memory_stats(device)``: live and peak device bytes from the
  CUDA caching allocator and the card's size, under the JAX package's key
  names; ``{}`` for a device without such statistics (the CPU);
- ``StepTimer``: the mean wall-clock time of steps, the first ones skipped
  (they build kernels and warm the allocator).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str):
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    return record_function(name)


def device_memory_stats(device=None) -> Dict[str, int]:
    device = torch.device(device if device is not None else
                          ("cuda" if torch.cuda.is_available() else "cpu"))
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }


class StepTimer:
    """Wall-clock step timing that ignores the first ``skip_first`` steps.
    Time a step that ends in a host read of its result (or a
    ``torch.cuda.synchronize()``): the device runs asynchronously."""

    def __init__(self, skip_first: int = 1):
        self.skip = skip_first
        self.count = 0
        self.total = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self.skip > 0:
            self.skip -= 1
        else:
            self.total += dt
            self.count += 1

    @property
    def mean(self) -> float:
        return self.total / max(1, self.count)
