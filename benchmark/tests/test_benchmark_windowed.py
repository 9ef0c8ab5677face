"""The readers of the windowed cell's own metrics on synthetic traces: K2's
roofline share (``k2_fwd_roofline.stream``) from the ``window_attn_fwd``
op's shapes and the device time launched under it, and the device ms under
the windowed layer's ``encoder.attn`` and ``encoder.ffn`` spans, which
read nothing where the program opens no such span (a program without
them, or a deformable model)."""
from __future__ import annotations

import pytest
import torch

from benchmark import counting, harness
from benchmark.drivers import Run

K2 = "memotr_tpu_torch::window_attn_fwd"
SPANS = ("window_attn_device_ms.stream", "window_ffn_device_ms.stream")
CONFIG = {"NUM_HEADS": 8, "DTYPE": "bfloat16"}


def _ev(kind, name, ts, dur, tid=1, corr=0, shapes=()):
    return {"kind": kind, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "corr": corr, "shapes": list(shapes)}


def _launch(ts, corr, dev_us, tid=1):
    return [_ev("launch", "cudaLaunchKernel", ts, 2, tid=tid, corr=corr),
            _ev("device", f"k{corr}", 5000 + ts, dev_us, corr=corr)]


def _k2(ts, x, bias, corr, dev_us):
    """One op call at ``ts`` on map ``x`` with bias table shape ``bias``
    ([] without one), launching one kernel of ``dev_us``."""
    c = x[-1]
    shapes = [x, x, x[:3], [3 * c, c], [3 * c], [c, c], [c], bias, [], [], []]
    return [_ev("op", K2, ts, 20, shapes=shapes)] + _launch(ts + 5, corr,
                                                            dev_us)


def _run(events, device="cuda", window=(0.0, 10_000.0)):
    return Run(workload="windowed_stream_b24", config=dict(CONFIG),
               traffic={}, seed=0, seconds=1.0, traced=True,
               device=torch.device(device), events=events,
               trace_window=window)


def _read(name, run):
    return harness.reader(name)(run)


def test_k2_roofline_is_the_bound_over_the_device_time_under_the_op():
    window, grid = [1, 104, 192, 256], [1, 104, 192, 256]
    events = (_k2(100, window, [8, 64, 64], corr=1, dev_us=150)
              + _k2(200, grid, [8, 312, 312], corr=2, dev_us=240)
              # without a bias table: left out
              + _k2(300, window, [], corr=3, dev_us=1000)
              # launched outside any op call: not K2's
              + _launch(400, corr=4, dev_us=5000))
    bound = (counting.k2_fwd_ms(1, 104, 192, 256, 64, 8, True, "bfloat16")
             + counting.k2_fwd_ms(1, 104, 192, 256, 312, 8, True,
                                  "bfloat16"))
    assert _read("k2_fwd_roofline.stream", _run(events)) \
        == pytest.approx(100.0 * bound / 0.390)


@pytest.mark.parametrize("events", [
    None, [],
    # no op call with a bias table
    _k2(300, [1, 16, 16, 256], [], corr=3, dev_us=100),
])
def test_k2_roofline_finds_nothing_without_biased_calls(events):
    assert _read("k2_fwd_roofline.stream", _run(events)) is None


def test_k2_roofline_reads_nothing_off_the_card():
    events = _k2(100, [1, 16, 16, 256], [8, 64, 64], corr=1, dev_us=10)
    assert _read("k2_fwd_roofline.stream", _run(events, "cpu")) is None


def _step(t0, spans=True):
    """A step whose encoder holds, when ``spans``, one level's
    ``encoder.attn`` (device us 40) and ``encoder.ffn`` (25) and one
    launch outside them (7)."""
    ev = [_ev("range", "submit.step", t0, 100),
          _ev("range", "model.encoder", t0 + 10, 60)]
    if spans:
        ev += [_ev("range", "encoder.lepe", t0 + 12, 5),
               _ev("range", "encoder.attn", t0 + 20, 20),
               _ev("range", "encoder.ffn", t0 + 45, 15)]
    for k, (at, us) in enumerate([(25, 40), (50, 25), (65, 7)]):
        ev += _launch(t0 + at, corr=int(t0) * 10 + k, dev_us=us)
    return ev


def test_span_readers_read_the_device_ms_a_step():
    run = _run(_step(100) + _step(300))
    assert _read("window_attn_device_ms.stream", run) == pytest.approx(0.040)
    assert _read("window_ffn_device_ms.stream", run) == pytest.approx(0.025)
    assert _read("encoder_device_ms.stream", run) == pytest.approx(0.072)


@pytest.mark.parametrize("events", [None, [], _step(100, spans=False)])
def test_span_readers_find_nothing_without_the_spans(events):
    run = _run(events)
    assert all(_read(name, run) is None for name in SPANS)
