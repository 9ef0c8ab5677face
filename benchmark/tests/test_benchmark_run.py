"""run.py's refusals, and what the benchmark's processes load: no module of
JAX or of the JAX package in a run, nothing of the program in the
reference."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BANNED = ("jax", "jaxlib", "flax", "memotr_tpu")


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_run_fails_without_a_card():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "dab_stream_b8", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=_clean_env(),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_run_fails_in_a_tree_of_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "dab_stream_b8", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=_clean_env(),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


_CELLS = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/benchmark/tests")
from conftest import SEED, TINY_CONFIG, TINY_STREAM
from benchmark import harness
bench = harness.spec()
for w in bench["workloads"]:
    harness.run_cell(w["name"], SEED, 0.5, w["name"] == "dab_stream_b8",
                     torch.device("cpu"), config_overrides=TINY_CONFIG,
                     traffic_overrides=TINY_STREAM)
    for kind in ("end_to_end", "per_layer"):
        for m in harness.metrics_for(w["name"], kind, bench):
            harness.reader(m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

_REFERENCE = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from benchmark import reference
from benchmark.reference.models.frame_step import eval_frame_step
cfg = json.load(open(sys.argv[1] + "/benchmark/configs/"
                     "memotr_dab_dancetrack.json"))["config"]
cfg = dict(cfg, HIDDEN_DIM=32, FFN_DIM=64, NUM_ENC_LAYERS=1,
           NUM_DEC_LAYERS=2, NUM_DET_QUERIES=10, TRACK_SLOTS=4)
m = reference.build(cfg).eval()
from benchmark.reference.structures.track_state import TrackState
st = TrackState.empty(1, 4, 32, m.num_classes)
with torch.no_grad():
    eval_frame_step(m, torch.zeros(1, 64, 96, 3),
                    torch.zeros(1, 64, 96, dtype=torch.bool), st, 0.5, 0.5,
                    30)
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
"""


def _top_level_names(script):
    p = subprocess.run([sys.executable, "-c", script, str(ROOT)], cwd=ROOT,
                       env=_clean_env(), capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_cells_load_no_jax_nor_the_jax_package():
    names = _top_level_names(_CELLS)
    assert "memotr_tpu_torch" in names          # whole names, not prefixes
    assert not names & set(BANNED), names & set(BANNED)


def test_reference_loads_nothing_of_the_program():
    names = _top_level_names(_REFERENCE)
    assert "benchmark" in names
    assert not names & (set(BANNED) | {"memotr_tpu_torch"})
