"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read.

A trace is a list of plain event dicts, so that the reduction runs on
synthetic traces in the tests as it does on the card's:

- ``kind``: ``device`` (a kernel, copy or set on the card), ``launch`` (the
  host's runtime call that enqueued one), ``op`` (a host operator, an
  autograd node among them) or ``range`` (a ``record_function`` range);
- ``name``, ``ts`` and ``dur`` in microseconds, ``tid`` (the host thread),
  ``corr`` (the correlation id: a device event shares its launch's),
  ``shapes`` (an operator's input shapes).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def _kind(e) -> str:
    """device / launch / range / op, or "" for what the reduction skips."""
    from torch.autograd import DeviceType
    act = getattr(e, "activity_type", None)
    if act is not None:
        act = str(act())
        return {"kernel": "device", "gpu_memcpy": "device",
                "gpu_memset": "device", "cuda_runtime": "launch",
                "cuda_driver": "launch", "user_annotation": "range",
                "cpu_op": "op"}.get(act, "")
    if e.device_type() == DeviceType.CUDA:
        return "" if e.is_user_annotation() else "device"
    if e.is_user_annotation():
        return "range"
    name = e.name()
    return "launch" if name.startswith(("cuda", "cu")) else "op"


def from_profiler(prof) -> List[Dict]:
    """The events of a finished ``torch.profiler.profile``, in memory (no
    trace file is written)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if not kind:
            continue
        out.append({"kind": kind, "name": e.name(),
                    "ts": e.start_ns() / 1e3, "dur": e.duration_ns() / 1e3,
                    "tid": e.start_thread_id(), "corr": e.correlation_id(),
                    "shapes": [list(s) for s in e.shapes()]
                    if kind == "op" else []})
    return out


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Merge overlapping [start, end) intervals."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def clip(intervals: Iterable[Interval], window: Interval) -> List[Interval]:
    lo, hi = window
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def device_intervals(events: Sequence[Dict]) -> List[Interval]:
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e["kind"] == "device"]


def busy_us(events: Sequence[Dict], window: Interval) -> float:
    """Microseconds of ``window`` in which some device operation ran: the
    length of the union of their intervals (overlapping streams count
    once)."""
    return sum(e - s for s, e in clip(union(device_intervals(events)),
                                      window))


def idle_share(events: Sequence[Dict], window: Interval) -> float:
    """1 - busy / window, in [0, 1]."""
    return 1.0 - busy_us(events, window) / (window[1] - window[0])


def calls(events: Sequence[Dict], name: str) -> List[Dict]:
    """Each host event named ``name`` with the device time of the
    operations it enqueued: those whose launch lies inside the event's
    span on its thread.  Returns dicts ``{"shapes", "device_us"}``."""
    launches = {}
    for e in events:
        if e["kind"] == "launch":
            launches[e["corr"]] = e
    by_thread: Dict[int, List[Tuple[float, float]]] = {}
    for e in events:
        if e["kind"] == "device" and e["corr"] in launches:
            lau = launches[e["corr"]]
            by_thread.setdefault(lau["tid"], []).append((lau["ts"], e["dur"]))
    for v in by_thread.values():
        v.sort()
    out = []
    for e in events:
        if e["kind"] in ("op", "range") and e["name"] == name:
            lo, hi = e["ts"], e["ts"] + e["dur"]
            dev = sum(d for t, d in by_thread.get(e["tid"], ()) if lo <= t <= hi)
            out.append({"shapes": e.get("shapes", []), "device_us": dev})
    return out


def top_device_ops(events: Sequence[Dict], window: Interval, n: int = 10
                   ) -> List[List]:
    """The ``n`` device operations (by name) that took most seconds in the
    window."""
    total: Dict[str, float] = {}
    for e in events:
        if e["kind"] == "device":
            s, t = max(e["ts"], window[0]), min(e["ts"] + e["dur"], window[1])
            if t > s:
                total[e["name"]] = total.get(e["name"], 0.0) + (t - s) / 1e6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events: Sequence[Dict], window: Interval,
              host_spans: Sequence[Tuple[str, float, float]], n: int = 10
              ) -> List[List]:
    """The ``n`` longest gaps in the window in which no device operation
    ran, each named by the benchmark's host ranges open at its midpoint
    (``host_spans``: (name, start us, end us); "none" where none was)."""
    busy = clip(union(device_intervals(events)), window)
    edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:n]:
        mid = (s + e) / 2
        names = sorted({name for name, a, b in host_spans if a <= mid <= b})
        out.append(["+".join(names) or "none", (e - s) / 1e6])
    return out


def shape_of(call: Dict, i: int) -> Optional[List[int]]:
    shapes = call.get("shapes") or []
    return shapes[i] if i < len(shapes) and shapes[i] else None
