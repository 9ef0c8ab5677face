"""Shared arithmetic of the metric readers.  Each reader is the file
``benchmark/metrics/<metric name>.py`` with ``read(run)``: the number, or
None where the run holds nothing to read it from."""
from __future__ import annotations

from typing import Optional

import numpy as np

from benchmark import counting, trace


def rate(run) -> Optional[float]:
    """Units completed inside the window, per second of the window."""
    t0, t1 = run.window
    if t1 <= t0:
        return None
    return sum(1 for t in run.done if t0 <= t <= t1) / (t1 - t0)


def dispatch_ms(run) -> Optional[float]:
    spans = run.spans_named("dispatch")
    if not spans:
        return None
    return float(np.mean([(b - a) * 1e3 for a, b in spans]))


def idle_percent(run) -> Optional[float]:
    if not run.events or run.trace_window[1] <= run.trace_window[0]:
        return None
    if not trace.device_intervals(run.events):
        return None
    return 100.0 * trace.idle_share(run.events, run.trace_window)


def stream_mfu(run) -> Optional[float]:
    """The run's untraced window's frames/s (host clock) times the model's
    FLOPs a frame (its matrix products and convolutions), over the peak of
    the configuration's dtype; the profiler would slow the host-bound
    loop, so the traced part's rate is not used."""
    fps = rate(run)
    if not fps or run.device.type != "cuda":
        return None
    flops = counting.stream_frame_flops(run.config, run.canvas)
    return 100.0 * flops * fps / counting.PEAK_FLOPS[run.config["DTYPE"]]


def roofline(run, op: str, select, bound_ms) -> Optional[float]:
    """Bound over device time, in %, of the calls of host op ``op`` that
    ``select(call)`` keeps; ``bound_ms(call)`` gives a call's least time."""
    if not run.events or run.device.type != "cuda":
        return None
    calls = [c for c in trace.calls(run.events, op)
             if c["device_us"] > 0 and select(c)]
    if not calls:
        return None
    bound = sum(bound_ms(c) for c in calls)
    return 100.0 * bound / (sum(c["device_us"] for c in calls) / 1e3)


def msda_dims(run):
    cfg = run.config
    m = cfg["NUM_HEADS"]
    return (m, cfg["HIDDEN_DIM"] // m, cfg["NUM_FEATURE_LEVELS"])
