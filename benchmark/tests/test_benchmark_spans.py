"""The readers of the program's spans (``benchmark/metrics/program_spans.py``
and the seven metrics on it) on synthetic traces, and on a traced run of
the cell at a small size on the CPU."""
from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.drivers import Run

DEVICE = ("launches.stream", "step_device_ms.stream",
          "backbone_device_ms.stream", "encoder_device_ms.stream",
          "decoder_device_ms.stream", "tracker_device_ms.stream")
ALL = DEVICE + ("loop_wait_ms.stream",)


def _ev(kind, name, ts, dur, tid=1, corr=0):
    return {"kind": kind, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "corr": corr, "shapes": []}


def _launch(ts, corr, dev_us, tid=1):
    """A launch on host thread ``tid`` and the device operation it
    enqueued, which runs later."""
    return [_ev("launch", "cudaLaunchKernel", ts, 2, tid=tid, corr=corr),
            _ev("device", f"k{corr}", 5000 + ts, dev_us, corr=corr)]


def _run(events, window=(0.0, 1000.0)):
    return Run(workload="dab_stream_b8", config={}, traffic={}, seed=0,
               seconds=1.0, traced=True, device=torch.device("cuda"),
               events=events, trace_window=window)


def _read(name, run):
    return harness.reader(name)(run)


def _step(t0, tid=1):
    """One step at ``t0`` on thread ``tid``: backbone, encoder, decoder,
    tracker and updater spans, one launch each and one in the step
    outside them (device us 10, 20, 30, 4, 6 and 1)."""
    ev = [_ev("range", "submit.step", t0, 100, tid),
          _ev("range", "model.backbone", t0 + 5, 10, tid),
          _ev("range", "model.encoder", t0 + 20, 20, tid),
          _ev("range", "model.decoder", t0 + 45, 20, tid),
          _ev("range", "step.tracker", t0 + 70, 5, tid),
          _ev("range", "step.updater", t0 + 80, 5, tid)]
    for k, (at, us) in enumerate([(8, 10), (25, 20), (50, 30), (72, 4),
                                  (82, 6), (95, 1)]):
        ev += _launch(t0 + at, corr=int(t0) * 10 + k, dev_us=us, tid=tid)
    return ev


def test_operations_belong_to_the_span_whose_thread_and_interval_hold_the_launch():
    events = _step(100)
    events += _launch(130, corr=90, dev_us=1000, tid=2)   # another thread
    events += _launch(250, corr=91, dev_us=500)           # after the step
    events += _launch(99, corr=92, dev_us=700)            # before it
    run = _run(events)
    assert _read("launches.stream", run) == 6
    assert _read("step_device_ms.stream", run) == pytest.approx(0.071)
    assert _read("backbone_device_ms.stream", run) == pytest.approx(0.010)
    assert _read("encoder_device_ms.stream", run) == pytest.approx(0.020)
    assert _read("decoder_device_ms.stream", run) == pytest.approx(0.030)
    assert _read("tracker_device_ms.stream", run) == pytest.approx(0.010)
    stages = sum(_read(n, run) for n in DEVICE[2:])
    assert stages <= _read("step_device_ms.stream", run)


def test_steps_outside_the_trace_window_are_left_out():
    events = _step(100) + _step(300) + _step(2000)
    events += _launch(2050, corr=99, dev_us=9000)         # in the late step
    run = _run(events, window=(0.0, 1000.0))
    assert _read("launches.stream", run) == 6
    assert _read("step_device_ms.stream", run) == pytest.approx(0.071)
    assert _read("encoder_device_ms.stream", run) == pytest.approx(0.020)
    # a step that starts inside the window counts whole
    run = _run(_step(950), window=(0.0, 1000.0))
    assert _read("step_device_ms.stream", run) == pytest.approx(0.071)


def test_loop_wait_is_the_dispatch_threads_waits_a_step():
    events = _step(100) + _step(300) + [
        _ev("range", "submit.wait_input", 50, 50),
        _ev("range", "submit.wait_writer", 200, 30),
        _ev("range", "submit.wait_input", 230, 70),
        _ev("range", "submit.wait_writer", 400, 10),
        _ev("range", "submit.wait_input", 1500, 400),     # after the window
        _ev("range", "submit.wait_device", 0, 900, tid=3),  # the writer
        _ev("range", "submit.wait_input", 0, 900, tid=3)]
    run = _run(events)
    assert _read("loop_wait_ms.stream", run) == pytest.approx(0.16 / 2)


@pytest.mark.parametrize("events", [
    None,
    [],
    # a program without spans: only the benchmark's ranges and kernels
    [_ev("range", "bench.window", 0, 2000), _ev("range", "bench.dispatch",
                                                100, 100)]
    + _launch(150, corr=1, dev_us=40),
])
def test_readers_find_nothing_without_the_programs_spans(events):
    run = _run(events)
    assert all(_read(name, run) is None for name in ALL)


def test_a_missing_stage_reads_none_and_the_others_read():
    events = [e for e in _step(100) if e["name"] != "model.neck"
              and e["name"] != "model.decoder"]
    run = _run(events)
    assert _read("decoder_device_ms.stream", run) is None
    assert _read("encoder_device_ms.stream", run) == pytest.approx(0.020)


def test_a_traced_cpu_run_reads_the_waits_and_no_device_time():
    from conftest import SEED, TINY_CONFIG, TINY_STREAM
    # a traced part of 3 s, so that steps start in it on a loaded host
    result = harness.run_cell("dab_stream_b8", SEED, 0.5, True,
                              torch.device("cpu"),
                              config_overrides=TINY_CONFIG,
                              traffic_overrides=dict(TINY_STREAM,
                                                     trace_seconds=3))
    metrics = result["metrics"]
    assert metrics["loop_wait_ms.stream"]["value"] >= 0.0
    assert not set(DEVICE) & set(metrics)
    assert result["correct"]
