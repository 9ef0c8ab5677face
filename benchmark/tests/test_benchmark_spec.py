"""BENCHMARK.json against the benchmark's contract, and the discovery of
cells, configurations, traffic mixes, limits and metric readers by name."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.spec()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS \
        + [m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names), names
    assert len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["reduced"] == []
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for name in CELLS:
        mine = {m["name"] for m in harness.metrics_for(name, "end_to_end",
                                                       BENCH)}
        assert "setup_s" in mine and len(mine) >= 2, name
        layer = harness.metrics_for(name, "per_layer", BENCH)
        assert layer, name
        for m in layer:
            assert m["moves"] in mine, (name, m["name"])
            assert e2e[m["moves"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_finds_its_files_by_name(workload):
    c = harness.cell(workload, BENCH)
    config = harness.config_of(c, BENCH)
    assert config["DTYPE"] == "bfloat16" and config["HIDDEN_DIM"] == 256
    traffic = harness.traffic_of(c)
    assert traffic["driver"] in ("stream",)
    limits = harness.limits_of(workload)
    assert limits, f"benchmark/limits/{workload}.json is missing"


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric))


def test_config_files_hold_the_published_widths():
    for c in BENCH["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["source"] == c["source"] and f["reduced"] == []
        cfg = f["config"]
        assert (cfg["HIDDEN_DIM"], cfg["FFN_DIM"], cfg["NUM_HEADS"],
                cfg["NUM_DEC_LAYERS"], cfg["NUM_DET_QUERIES"],
                cfg["NUM_FEATURE_LEVELS"]) == (256, 2048, 8, 6, 300, 4)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        harness.cell("no_such_cell", BENCH)
