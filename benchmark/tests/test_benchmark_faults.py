"""A run with its timed path broken underneath comes out not correct, for
each fault a cell can have (``benchmark/faults.py``): a step that returns
its state unchanged, half of the batch left out (the mean taken over the
rest), an answer altered where it is produced.  The cells run on one
chip: there is no exchange between chips to leave out."""
from __future__ import annotations

import pytest

from benchmark import faults, harness

CASES = [(w["name"], name) for w in harness.spec()["workloads"]
         for name in faults.FAULTS]


@pytest.mark.parametrize("workload,fault", CASES)
def test_stream_fault_is_not_correct(run_tiny, monkeypatch, workload, fault):
    faults.FAULTS[fault](monkeypatch.setattr)
    r = run_tiny(workload)
    assert r["correct"] is False, r["checks"]

