"""Shared settings of the benchmark's CPU tests: the repository root on
``sys.path``, the small sizes at which the tests run whole cells, and a
windowed cell that lives in memory and under pytest's ``tmp_path`` only."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

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


# the windowed flagship (configs/train_dancetrack_windowed.yaml) at the
# small widths, with its three encoder layers: window, grid, window
WINDOWED_YAML = ROOT / "configs" / "train_dancetrack_windowed.yaml"
WINDOWED_CELL = "windowed_tiny"


@pytest.fixture
def windowed_cell(tmp_path):
    """``windowed_cell(**config) -> (bench, run)``: a spec with one cell,
    the windowed configuration at ``TINY_CONFIG`` widths (its file under
    ``tmp_path``) streamed as ``lanes8_dancetrack`` at ``TINY_STREAM``, and
    ``run(**kw)``, one run of it on the CPU.  The cell has no limits file,
    so its ``correct`` reads false; its ``checks`` are what it gives."""
    import torch
    import yaml

    from benchmark import harness

    def make(**config):
        cfg = yaml.safe_load(WINDOWED_YAML.read_text())
        cfg.update(dict(TINY_CONFIG, NUM_ENC_LAYERS=cfg["NUM_ENC_LAYERS"]),
                   **config)
        path = tmp_path / "memotr_windowed_tiny.json"
        path.write_text(json.dumps({"config": cfg}))
        real = harness.spec()
        bench = {"configs": [{"name": "memotr_windowed_tiny",
                              "file": str(path)}],
                 "workloads": [{"name": WINDOWED_CELL,
                                "config": "memotr_windowed_tiny",
                                "traffic": "lanes8_dancetrack", "chips": 1}],
                 "end_to_end": [dict(m, workloads=[WINDOWED_CELL])
                                for m in real["end_to_end"]],
                 "per_layer": []}

        def run(seconds=1.0, **kw):
            return harness.run_cell(WINDOWED_CELL, SEED, seconds, False,
                                    torch.device("cpu"), bench=bench,
                                    traffic_overrides=TINY_STREAM, **kw)
        return bench, run
    return make
