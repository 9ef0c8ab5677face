"""How a cell drives the program, chosen by its traffic file's ``driver``
(``DRIVERS``): ``stream`` runs ``BatchedSubmitter.run`` over ``lanes``
endless lanes in a closed loop (the next batch goes out as the pipelined
loop takes it).

Each driver sets up (model, weights, inputs, a warm-up over the cell's own
shapes), runs the window, and fills a ``Run`` with what the metrics read:
host times stamped by the benchmark around its calls into the program
(``spans``), completion times, memory, and the trace in a traced run.  It
also keeps, for the check after the window, the inputs and outputs of the
steps the seed samples.  The program is imported inside the drivers only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import gen
from .trace import from_profiler

STATE_FIELDS = ("mask", "ids", "labels", "disappear_time", "next_id",
                "query_embed", "ref_pts", "logits", "boxes", "output_embed",
                "last_output", "long_memory", "last_appear_boxes")
FORWARD_KEYS = ("pred_logits", "pred_boxes", "outputs", "last_ref_pts",
                "det_query_embed")
# the traced part's first second is left out of its window: a new streamer
# builds its eval cache, starts its threads and fills its pipeline there
TRACE_LEAD_S = 1.0


@dataclasses.dataclass
class Run:
    """What one run of a cell measured and kept."""
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    setup_s: float = 0.0
    window: Tuple[float, float] = (0.0, 0.0)
    done: List[float] = dataclasses.field(default_factory=list)
    spans: List[Tuple[str, float, float]] = dataclasses.field(
        default_factory=list)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    events: Optional[List[Dict]] = None
    trace_window: Tuple[float, float] = (0.0, 0.0)
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0
    window_peak: int = 0
    samples: Dict[str, Any] = dataclasses.field(default_factory=dict)
    canvas: Tuple[int, int] = (0, 0)

    def in_window(self, t: float) -> bool:
        return self.window[0] <= t <= self.window[1]

    def spans_named(self, name: str) -> List[Tuple[float, float]]:
        return [(a, b) for n, a, b in self.spans
                if n == name and self.in_window(b)]


class Recorder:
    """Host spans around the benchmark's calls into the program, also as
    ``record_function`` ranges (``bench.<name>``) when tracing."""

    def __init__(self, run: Run):
        self.run = run
        self.lock = threading.Lock()
        self.tracing = False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = torch.profiler.record_function(f"bench.{name}") \
            if self.tracing else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        t1 = time.perf_counter()
        with self.lock:
            self.run.spans.append((name, t0, t1))


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def profiled(run: Run, rec: Recorder, seconds: float):
    """The profiler (CPU and CUDA activity, shapes recorded) over a traced
    part that follows the untraced window, its events into ``run.events``
    and ``seconds`` of it after ``TRACE_LEAD_S`` as ``run.trace_window``
    (in the trace's clock).  The untraced window gives the host times and rates; the
    traced part the device's idle share, kernel times and breakdown (the
    profiler slows the host's dispatch)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    rec.tracing = True
    try:
        with profile(activities=acts, record_shapes=True) as prof:
            with torch.profiler.record_function("bench.window"):
                yield
            synchronize(run.device)
    finally:
        rec.tracing = False
    run.events = from_profiler(prof)
    win = [e for e in run.events if e["kind"] == "range"
           and e["name"] == "bench.window"]
    if win:
        ts = win[0]["ts"] + TRACE_LEAD_S * 1e6
        run.trace_window = (ts, min(ts + seconds * 1e6,
                                    win[0]["ts"] + win[0]["dur"]))


def sample_steps(seed: int, n: int, count: int) -> List[int]:
    """Step 0 (the start, from empty track slots) and ``count - 1`` more of
    the first ``n`` steps, drawn from the seed."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 7])
    rest = rng.choice(np.arange(1, max(n, count)), size=count - 1,
                      replace=False) if count > 1 else []
    return sorted({0, *map(int, rest)})


def build_program_model(config: dict, device: torch.device, seed: int,
                        prepare=None):
    """The program's model on ``device`` with the benchmark's weights made
    from ``seed`` (to its names and shapes; ``prepare(weights)`` may
    adjust them first).  Returns (model, weights)."""
    from memotr_tpu_torch.models.memotr import build_model
    with torch.device(device):
        model = build_model(config)
    weights = gen.make_weights(model, seed, device)
    if prepare is not None:
        prepare(weights)
    model.load_state_dict(weights)
    return model, weights


def _clone_state(state) -> Dict[str, torch.Tensor]:
    return {f: getattr(state, f).clone() for f in STATE_FIELDS}


def _out_dir(run: Run) -> str:
    """Where the submitter writes its MOT txt files: under the run's
    TMPDIR, removed after the window."""
    return tempfile.mkdtemp(prefix=f"bench-{run.workload}-")


# ------------------------------------------------------------------- stream
class _StepTap:
    """Wraps a streamer's ``_step`` (and its model's ``forward``): times each
    call as a ``dispatch`` span and keeps the inputs, the forward's outputs
    and the next state of the sampled steps."""

    def __init__(self, streamer, rec: Recorder, sample: List[int]):
        self.streamer, self.rec = streamer, rec
        self.sample = set(sample)
        self.kept: Dict[int, Dict] = {}
        self.calls = 0
        self._forward_out: Optional[Dict] = None
        self._orig_step = streamer._step
        model = streamer.model
        self._orig_forward = model.forward
        streamer._step = self._step
        model.forward = self._forward

    def _forward(self, *args, **kwargs):
        out = self._orig_forward(*args, **kwargs)
        if self._forward_out is not None:
            self._forward_out.update(
                {k: out[k].detach().clone() for k in FORWARD_KEYS})
            self._forward_out["queries_last"] = out["queries"][-1].clone()
        return out

    def _step(self, images, mask, host_mask, state):
        k = self.calls
        self.calls += 1
        with self.rec.span("dispatch"):
            keep = k in self.sample
            if keep:
                entry = {"images": images.clone(), "mask": mask.clone(),
                         "state_in": _clone_state(state), "forward": {}}
                self._forward_out = entry["forward"]
            results, nxt = self._orig_step(images, mask, host_mask, state)
            if keep:
                self._forward_out = None
                entry["state_out"] = _clone_state(nxt)
                self.kept[k] = entry
        return results, nxt

    def close(self):
        self.streamer._step = self._orig_step
        self.streamer.model.forward = self._orig_forward


@contextlib.contextmanager
def _write_stamps(run: Run, rec: Recorder, sample: List[int]):
    """Stamps every lane-frame the writer formats (``format_frame_results``
    of the submit engine, looked up there at each call) and keeps the
    results the writer got for the sampled frames."""
    from memotr_tpu_torch.engine import submit as engine
    orig = engine.format_frame_results
    stamps: List[Tuple[int, int, float]] = []
    written: Dict[int, Dict[int, Dict]] = {}
    keep = set(sample)

    def wrapped(i, results, ori_hw, path, *args, lane=0, **kwargs):
        with rec.span("writer"):
            out = orig(i, results, ori_hw, path, *args, lane=lane, **kwargs)
        if i in keep:
            written.setdefault(i, {})[lane] = {
                k: np.array(v[lane]) for k, v in results.items()}
        stamps.append((i, lane, time.perf_counter()))
        return out

    engine.format_frame_results = wrapped
    try:
        yield stamps, written
    finally:
        engine.format_frame_results = orig


def calibrate(run: Run, weights: Dict[str, torch.Tensor],
              frames: Dict) -> None:
    """The class heads calibrated on the first lane's first frame to the
    traffic's ``detections`` (``gen.calibrate_detections``).  The
    reference computes it: its seconds go to ``counters["calibrate_s"]``,
    which set-up leaves out, and its memory peak is forgotten."""
    k = run.traffic.get("detections")
    if not k:
        return
    synchronize(run.device)
    t0 = time.perf_counter()
    gen.calibrate_detections(weights, run.config, frames["images"][0, 0],
                             frames["mask"], int(k), run.device)
    synchronize(run.device)
    run.counters["calibrate_s"] = time.perf_counter() - t0
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(run.device)


def setup_seconds(run: Run, t_setup: float) -> float:
    """Seconds since ``t_setup``, less the reference's calibration."""
    return time.perf_counter() - t_setup - run.counters.get("calibrate_s",
                                                            0.0)


def _stream_frames(run: Run) -> Dict:
    t = run.traffic
    return gen.stream_lanes(
        run.seed, run.device, t["lanes"], t["ring"], t["ori_hw"],
        t["canvas"], t["short_side"], t["max_side"], t["objects"],
        t["size_lo"], t["size_hi"], t["speed"])


def drive_stream(run: Run) -> None:
    from memotr_tpu_torch.engine.submit import BatchedSubmitter
    t, cfg = run.traffic, run.config
    rec = Recorder(run)
    t_setup = time.perf_counter()
    frames = _stream_frames(run)
    model, weights = build_program_model(
        cfg, run.device, seed=run.seed,
        prepare=lambda w: calibrate(run, w, frames))
    model.eval()
    lanes, ori_hw = t["lanes"], t["ori_hw"]
    names = [f"lane{i:02d}" for i in range(lanes)]
    out_dir = _out_dir(run)

    def submitter(length):
        seqs = [gen.Lane(frames["images"][i], frames["mask"], ori_hw, length)
                for i in range(lanes)]
        return BatchedSubmitter(cfg["DATASET"], seqs, names, out_dir, model,
                                cfg, run.device)

    warm = submitter(int(t["warmup_steps"]))
    warm.run()
    synchronize(run.device)
    steady = np.asarray(warm.frame_seconds[2:]) if len(
        warm.frame_seconds) > 3 else np.asarray(warm.frame_seconds)
    rate = 1.0 / max(float(np.median(steady)), 1e-4)       # steps/s
    run.setup_s = setup_seconds(run, t_setup)

    seconds = run.seconds
    n_steps = int(math.ceil(rate * seconds * float(t["overrun"]))) + 8
    sample = sample_steps(run.seed, max(2, int(rate * seconds * 0.8)),
                          int(t["check_steps"]))
    sub = submitter(n_steps)
    tap = _StepTap(sub, rec, sample)
    run.memory_peak = _peak(run)
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    try:
        with _write_stamps(run, rec, sample) as (stamps, written):
            t0 = time.perf_counter()
            run.window = (t0, t0 + seconds)
            sub.run()
            t_end = time.perf_counter()
    finally:
        tap.close()
    synchronize(run.device)
    run.window_peak = _peak(run)
    if t_end < run.window[1]:
        raise RuntimeError(f"the run ended {run.window[1] - t_end:.2f} s "
                           f"before its window closed: raise 'overrun'")
    run.done = [s for _, _, s in stamps]
    run.attempted = lanes * len(run.spans_named("dispatch"))
    wrote = {(i, lane) for i, lane, _ in stamps}
    run.failed = sum(1 for i in range(n_steps) for lane in range(lanes)
                     if (i, lane) not in wrote)
    run.canvas = tuple(t["canvas"])
    run.samples = {"weights": weights, "steps": tap.kept,
                   "written": written}
    if run.traced:
        traced = float(t["trace_seconds"])
        sub = submitter(int(math.ceil(rate * (TRACE_LEAD_S + traced))) + 4)
        tap = _StepTap(sub, rec, [])
        try:
            with _write_stamps(run, rec, []), profiled(run, rec, traced):
                sub.run()
        finally:
            tap.close()
    shutil.rmtree(out_dir, ignore_errors=True)


def _peak(run: Run) -> int:
    if run.device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(run.device))


DRIVERS = {"stream": drive_stream}
