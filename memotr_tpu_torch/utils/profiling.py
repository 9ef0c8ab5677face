"""Tracing and profiling hooks (counterpart of
``memotr_tpu/utils/profiling.py``).

- ``trace(logdir)``: ``torch.profiler`` over a region (host and, on a
  card, CUDA activity, on every thread), written to ``logdir`` as a Chrome
  trace (``trace.json``, viewable in Perfetto); the profile is returned
  for ``key_averages()``;
- ``span(name)``: a named range in the profiler's own timeline
  (``record_function``) while a profiler records, else a shared null
  context after one flag check;
- ``device_memory_stats(device)``: live and peak device bytes from the
  CUDA caching allocator and the card's size, under the JAX package's key
  names; ``{}`` for a device without such statistics (the CPU);
- ``StepTimer``: the mean wall-clock time of steps, the first ones skipped
  (they build kernels and warm the allocator).

The streaming path opens these spans, each at a layer boundary (names are
fixed strings):

- prefetch thread (``engine/submit.py: _prefetch``, ``stream_pipelined``):
  ``submit.prepare`` (building a batch: a ``BatchedSubmitter``'s
  ``np.stack`` of the lanes, a ``Submitter``'s decoded frame),
  ``submit.upload`` (pinning, the ``non_blocking`` copy and its event);
- dispatch thread: ``submit.wait_input`` (blocked on the prefetch queue),
  ``submit.step`` (the frame step), ``submit.copy_out`` (the copy into the
  pinned result ring and its event), ``submit.wait_writer`` (blocked
  putting to the writer's queue);
- inside ``submit.step`` (``_Streamer._step``, ``eval_frame_step``, the
  model): ``step.eval_cache`` (the lookup; a rebuild nests
  ``step.eval_cache_build``), ``step.normalize``, ``model.backbone``,
  ``model.neck`` (input projections, masks, position maps),
  ``model.encoder`` (flattening and the encoder layers, K1 included;
  inside a windowed layer, per level, ``encoder.lepe``, ``encoder.attn``
  (K2 with its padding and grid transpose) and ``encoder.ffn``, then
  ``encoder.fuse`` once),
  ``model.decoder`` (the decoder and its heads), ``step.tracker``,
  ``step.updater``, ``step.pack``;
- writer thread: ``submit.wait_device`` (waiting for the result's copy),
  ``submit.write`` (unpacking and formatting).

Spans nest on their thread, so each has its parent.  Spans of one frame
share an identifier by order: the k-th ``submit.upload``, ``submit.step``
and ``submit.write`` of one streamer belong to its batch k (each thread
handles the batches in order).  The model's spans open wherever the model
runs (training too).  Under ``torch.compile`` or ``torch.export`` a span
opens nothing, so an exported program holds no profiler node.

A profiler started with its defaults records the ranges of the thread
that started it only (the dispatch thread, for a submitter run from that
thread); ``trace`` records every thread's.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch
from torch._C._profiler import _ExperimentalConfig
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

# what ``span`` returns while no profiler records: shared, allocates nothing
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str):
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, experimental_config=
                 _ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def span(name: str):
    """A ``record_function`` range named ``name`` while ``torch.profiler``
    records (and no compiler traces), else the shared null context.  The
    check reads the profiler's process-wide flag, so the null path costs
    one attribute read."""
    if not autograd_profiler._is_profiler_enabled or \
            torch.compiler.is_compiling():
        return _NULL
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
