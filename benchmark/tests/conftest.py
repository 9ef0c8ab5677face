"""Shared settings of the benchmark's CPU tests: the repository root on
``sys.path``, and the small sizes at which the tests run whole cells."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

# the cells' configurations at small widths, in float32 on the CPU
TINY_CONFIG = {"HIDDEN_DIM": 32, "FFN_DIM": 64, "NUM_ENC_LAYERS": 1,
               "NUM_DEC_LAYERS": 2, "NUM_DET_QUERIES": 20, "TRACK_SLOTS": 8,
               "DTYPE": "float32"}
TINY_STREAM = {"ori_hw": [108, 192], "canvas": [64, 128], "short_side": 64,
               "max_side": 128, "lanes": 2, "ring": 3, "objects": 3,
               "warmup_steps": 3, "trace_seconds": 1, "detections": 5}
SEED = 3_000_000_019


@pytest.fixture
def run_tiny():
    """``run_tiny(workload, **kw)``: one run of the cell at the small size
    on the CPU (the harness's look for a card skipped)."""
    import torch

    from benchmark import harness

    def run(workload, seconds=1.0, traced=False, **kw):
        return harness.run_cell(workload, SEED, seconds, traced,
                                torch.device("cpu"),
                                config_overrides=TINY_CONFIG,
                                traffic_overrides=TINY_STREAM, **kw)
    return run
