"""The plain reference against the program at small widths in float32 on
the CPU (a few streamed frames of every lane), and the control (the
reference in float8 in the program's place), which each cell's limits
must refuse."""
from __future__ import annotations

import pytest

from benchmark import check, harness

CELLS = [w["name"] for w in harness.spec()["workloads"]]
# float32 on both sides, on the CPU: the stage check runs the same float32
# operations (0 apart); the forward differs only where the program reads
# its eval cache's position maps (numpy) for the reference's torch ones
AGREE = {"logit_rms": 5e-3, "box_rms": 5e-3, "state_gap": 1e-5,
         "state_mismatch": 0.0, "rows_gap": 0.0}


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_and_the_control_is_refused(run_tiny, workload):
    r = run_tiny(workload, control=True)
    got = {k: v["value"] for k, v in r["checks"].items()}
    for k, v in got.items():
        assert v <= AGREE[k], (k, v)
    assert r["correct"], r["checks"]
    control = {k: v for k, v in r["control"].items() if k != "details"}
    assert check.judge(control, harness.limits_of(workload)) is False, \
        control


@pytest.mark.parametrize("option", [("ENCODER_TYPE", "windowed"),
                                    ("USE_DAB", False), ("DROPOUT", 0.1),
                                    ("EXTRA_TRACK_ATTN", True)])
def test_reference_refuses_what_it_does_not_implement(option):
    from benchmark import reference
    from benchmark.tests.conftest import TINY_CONFIG
    cfg = dict(harness.config_of(harness.cell("dab_stream_b8", harness.spec()),
                                 harness.spec()), **TINY_CONFIG)
    reference.build(cfg)
    with pytest.raises(ValueError):
        reference.build(dict(cfg, **dict([option])))
