"""Per-step readings of the program's own spans
(``memotr_tpu_torch/utils/profiling.py: span``) in a traced run's events.

A step is a ``submit.step`` range that starts inside ``run.trace_window``.
A device operation (kernel, copy or set) belongs to a span when its launch
(the host's runtime call, matched by correlation id) lies inside the span
on the span's thread, as ``trace.calls`` attributes them.  Every function
returns None where the run holds no such span (a program without spans),
and the device readings where the trace holds no device operation.

The trace labels a launch with the thread of the recorded host op that
encloses it.  A launch from a thread the profiler does not record (the
prefetch thread's upload copies) has none and takes the id of the thread
that stopped the profiler, the dispatch thread: it counts in the span
open at its launch.
"""
from __future__ import annotations

import bisect
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

STEP = "submit.step"
WAITS = ("submit.wait_input", "submit.wait_writer")


def _ranges(run, names: Sequence[str]) -> List[Dict]:
    return [e for e in run.events or () if e["kind"] == "range"
            and e["name"] in names]


def steps(run) -> List[Dict]:
    """The ``submit.step`` ranges that start inside the trace window."""
    lo, hi = run.trace_window
    return [e for e in _ranges(run, (STEP,)) if lo <= e["ts"] <= hi]


def _inside(e: Dict, outer: Sequence[Dict]) -> bool:
    return any(o["tid"] == e["tid"] and o["ts"] <= e["ts"]
               and e["ts"] + e["dur"] <= o["ts"] + o["dur"] for o in outer)


def _launched(events) -> Dict[int, Tuple[List[float], List[float]]]:
    """Per host thread: the launch times of the device operations, sorted,
    and the running sum of their device microseconds (one more entry)."""
    launches = {e["corr"]: e for e in events if e["kind"] == "launch"}
    by_thread: Dict[int, List[Tuple[float, float]]] = {}
    for e in events:
        if e["kind"] == "device" and e["corr"] in launches:
            lau = launches[e["corr"]]
            by_thread.setdefault(lau["tid"], []).append((lau["ts"], e["dur"]))
    out = {}
    for tid, v in by_thread.items():
        v.sort()
        out[tid] = ([t for t, _ in v],
                    list(itertools.accumulate((d for _, d in v), initial=0.0)))
    return out


def device_per_step(run, names: Sequence[str]
                    ) -> Optional[Tuple[float, float]]:
    """(device operations, device ms) launched inside the ranges named
    ``names`` that lie inside the window's steps, mean a step."""
    st = steps(run)
    ranges = st if tuple(names) == (STEP,) else \
        [e for e in _ranges(run, names) if _inside(e, st)]
    if not st or not ranges:
        return None
    table = _launched(run.events)
    if not table:               # no device in the trace (a CPU run)
        return None
    count, us = 0, 0.0
    for r in ranges:
        ts, total = table.get(r["tid"], ([], [0.0]))
        i = bisect.bisect_left(ts, r["ts"])
        j = bisect.bisect_right(ts, r["ts"] + r["dur"])
        count += j - i
        us += total[j] - total[i]
    return count / len(st), us / 1e3 / len(st)


def device_ms(run, names: Sequence[str]) -> Optional[float]:
    got = device_per_step(run, names)
    return None if got is None else got[1]


def wait_ms(run) -> Optional[float]:
    """Host ms a step that the steps' thread spent in ``submit.wait_input``
    or ``submit.wait_writer``: the waits that start inside the trace
    window over the steps that do."""
    st = steps(run)
    if not st:
        return None
    lo, hi = run.trace_window
    tids = {e["tid"] for e in st}
    waits = [e for e in _ranges(run, WAITS)
             if e["tid"] in tids and lo <= e["ts"] <= hi]
    if not waits:
        return None
    return sum(e["dur"] for e in waits) / 1e3 / len(st)
