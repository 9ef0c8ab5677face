"""A run with its timed path broken underneath comes out not correct, for
each fault a cell can have (``benchmark/faults.py``, and the fault files
of ``benchmark/planted/``): a step that returns its state unchanged, half
of the batch left out (the mean taken over the rest), an answer altered
where it is produced, the windowed attention's position bias dropped.  A
cell is paired only with the faults that can touch its configuration.
The cells run on one chip: there is no exchange between chips to leave
out."""
from __future__ import annotations

import pytest

from benchmark import faults, harness
from benchmark.tests.test_benchmark_reference import AGREE

BENCH = harness.spec()
CASES = [(w["name"], name) for w in BENCH["workloads"]
         for name in faults.FAULTS
         if faults.applies(name, harness.config_of(w, BENCH))]
WINDOWED_FAULTS = [name for name in faults.FAULTS
                   if faults.applies(name, {"ENCODER_TYPE": "windowed"})]


@pytest.mark.parametrize("workload,fault", CASES)
def test_stream_fault_is_not_correct(run_tiny, monkeypatch, workload, fault):
    faults.FAULTS[fault](monkeypatch.setattr)
    r = run_tiny(workload)
    assert r["correct"] is False, r["checks"]


def test_faults_say_where_they_apply():
    assert faults.ENCODERS["window_bias_dropped"] == ("windowed", "hybrid")
    for name in ("state_unchanged", "half_lanes", "answer_altered"):
        assert name not in faults.ENCODERS
        assert faults.applies(name, {})
    assert not faults.applies("window_bias_dropped", {})
    assert faults.applies("window_bias_dropped", {"ENCODER_TYPE": "hybrid"})


@pytest.mark.parametrize("fault", WINDOWED_FAULTS)
def test_a_fault_moves_the_in_memory_windowed_cell(windowed_cell,
                                                   monkeypatch, fault):
    """Each fault that reaches the windowed model pushes at least one of
    the windowed cell's readings beyond what the sound program reads
    (``AGREE``)."""
    _, run = windowed_cell()
    faults.FAULTS[fault](monkeypatch.setattr)
    got = {k: v["value"] for k, v in run()["checks"].items()}
    assert any(v > AGREE[k] for k, v in got.items()), got
