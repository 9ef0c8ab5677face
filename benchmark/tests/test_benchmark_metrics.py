"""The metric arithmetic on synthetic timestamps and traces, and the
counting functions against PERF.md's kernel table and a hand count."""
from __future__ import annotations

import pytest
import torch

from benchmark import counting, trace
from benchmark.drivers import Run
from benchmark.metrics.common import rate


def _run(**kw):
    r = Run(workload="x", config={}, traffic={}, seed=0, seconds=10.0,
            traced=False, device=torch.device("cpu"))
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_a_stall_in_the_window_lowers_stream_fps():
    steady = [0.01 * (i + 1) for i in range(1000)]            # 100/s
    stalled = [t if t < 4.0 else t + 2.0 for t in steady]     # 2 s stall
    a = rate(_run(window=(0.0, 10.0), done=steady))
    b = rate(_run(window=(0.0, 10.0), done=stalled))
    assert a == pytest.approx(100.0)
    assert b == pytest.approx(80.0)


def test_setup_leaves_out_the_calibration():
    import time

    from benchmark.drivers import setup_seconds
    t0 = time.perf_counter() - 10.0
    run = _run(counters={"calibrate_s": 4.0})
    assert setup_seconds(run, t0) == pytest.approx(6.0, abs=0.5)
    assert setup_seconds(_run(), t0) == pytest.approx(10.0, abs=0.5)


def _ev(kind, name, ts, dur, tid=1, corr=0, shapes=()):
    return {"kind": kind, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "corr": corr, "shapes": list(shapes)}


def test_idle_share_is_one_minus_the_union_of_kernel_intervals():
    events = [_ev("device", "a", 0, 40), _ev("device", "b", 20, 40),  # overlap
              _ev("device", "c", 70, 10), _ev("device", "d", 150, 100)]
    window = (0.0, 200.0)
    assert trace.busy_us(events, window) == pytest.approx(60 + 10 + 50)
    assert trace.idle_share(events, window) == pytest.approx(1 - 120 / 200)
    # summed kernel times would count the overlap twice
    assert sum(e["dur"] for e in events if e["ts"] < 200) > 120


def test_gaps_are_named_by_the_open_host_range():
    events = [_ev("device", "k", 0, 10), _ev("device", "k", 50, 5)]
    gaps = trace.idle_gaps(events, (0.0, 100.0),
                           [("dispatch", 15.0, 45.0), ("writer", 70, 99)])
    assert gaps[0] == ["writer", pytest.approx(45 / 1e6)]
    assert gaps[1] == ["dispatch", pytest.approx(40 / 1e6)]


def test_kernels_belong_to_the_op_whose_span_launched_them():
    events = [
        _ev("op", "memotr_tpu_torch::msda_fwd", 100, 50, tid=1,
            shapes=[[1, 10, 8, 32], [], [1, 10, 8, 4, 4, 2], [1, 10, 8, 4, 4]]),
        _ev("launch", "cudaLaunchKernel", 120, 2, tid=1, corr=7),
        _ev("launch", "cudaLaunchKernel", 300, 2, tid=1, corr=8),
        _ev("launch", "cudaLaunchKernel", 130, 2, tid=2, corr=9),
        _ev("device", "msda_kernel", 400, 30, corr=7),
        _ev("device", "other", 500, 80, corr=8),
        _ev("device", "other_thread", 600, 80, corr=9),
    ]
    calls = trace.calls(events, "memotr_tpu_torch::msda_fwd")
    assert len(calls) == 1 and calls[0]["device_us"] == 30
    assert trace.shape_of(calls[0], 2) == [1, 10, 8, 4, 4, 2]


def test_kernel_bounds_reproduce_perf_md():
    # PERF.md's kernel table: K1 encoder at 800x1536, K1 backward encoder
    # at 896x1536, K2 window / grid level 0 at 800x1536
    enc = sum(h * w for h, w in counting.pyramid_shapes(800, 1536))
    enc_t = sum(h * w for h, w in counting.pyramid_shapes(896, 1536))
    assert (enc, enc_t) == (25512, 28560)
    assert counting.k1_fwd_ms(1, enc, enc, 8, 32, 4, 4, "bfloat16") \
        == pytest.approx(0.0195, abs=5e-5)
    assert counting.k1_bwd_ms(1, enc_t, enc_t, 8, 32, 4, 4, "bfloat16") \
        == pytest.approx(0.0559, abs=5e-5)
    assert counting.k2_fwd_ms(1, 104, 192, 256, 64, 8, True, "bfloat16") \
        == pytest.approx(0.0119, abs=5e-5)
    assert counting.k2_fwd_ms(1, 104, 192, 256, 312, 8, True, "bfloat16") \
        == pytest.approx(0.0170, abs=5e-5)


def test_one_encoder_layer_matches_a_hand_count():
    """A deformable encoder layer over S tokens: value and output
    projections (C x C), sampling offsets (C x M L P 2), attention weights
    (C x M L P), the FFN (C x F, F x C), two operations a multiply-add;
    the bilinear sampling is not counted."""
    from benchmark.counting import _counted
    from benchmark.reference.models.encoder import EncoderLayer
    c, f, m, lv, p = 256, 2048, 8, 4, 4
    shapes = counting.pyramid_shapes(64, 96)
    s = sum(h * w for h, w in shapes)
    layer = EncoderLayer(c, f, lv, m, p).to("meta")
    x = torch.zeros((1, s, c), device="meta")
    ref = torch.zeros((1, s, lv, 2), device="meta")
    mask = torch.zeros((1, s), dtype=torch.bool, device="meta")
    got = _counted(lambda: layer(x, x, ref, shapes, mask))
    hand = 2 * s * (c * c + c * m * lv * p * 2 + c * m * lv * p + c * c
                    + 2 * c * f)
    assert got == hand


def test_frame_flops_split():
    import json
    from pathlib import Path
    root = Path(__file__).resolve().parents[2]
    cfg = json.loads((root / "benchmark/configs/memotr_dab_dancetrack.json")
                     .read_text())["config"]
    f = counting.frame_flops(cfg, (800, 1536))
    # ResNet-50 at 800x1536 is ~24.5x its 224x224 count (4.1 GMAC);
    # six encoder layers over 25,512 tokens at ~2.56 MFLOP a token
    assert 5.5e11 < f["total"] < 7.5e11
    assert 0 < f["updater"] < 1e10
    assert f["total"] == f["forward"] + f["updater"]
