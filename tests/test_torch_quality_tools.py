"""The port's ``quality_report`` and ``scalars_report`` against the root
``tools/`` copies (pure Python and numpy, no JAX).

Seeded ``<variant>_s<seed>/val/checkpoint_<E>_metrics.json`` files and
``train/scalars.jsonl`` streams (losses, the eval's epoch records, a blank
line and a record in the old repr format) in one workdir; both tools run
in this process on the same files, with the same arguments: the same
stdout, byte for byte, and the same JSON.
"""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from memotr_tpu_torch.tools import quality_report, scalars_report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# variants that exercise the prefix pairs (the longest base), the
# cross-family pairs and a single-seed row
RUNS = {"deformable": (42, 43), "windowed": (42, 43),
        "windowed_transplant": (42, 43),
        "windowed_transplant_distill": (42,), "deformable_w256": (42, 43),
        "windowed_w256_transplant": (42, 43),
        "hybrid_w256_transplant": (42,)}
EPOCHS = 10


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scalars(path, rng, n_rows, with_old_format):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for i in range(n_rows):
            row = {"step": 100 * i, "mode": "iters",
                   "total_loss": float(rng.uniform(2, 12) / (1 + i)),
                   "box_l1_loss": float(rng.uniform(0.1, 1.0)),
                   "time per iter": float(rng.uniform(0.1, 0.4))}
            f.write(json.dumps(row) + "\n")
            if i == 2:
                f.write("\n")
        f.write(json.dumps({"step": 9, "mode": "epochs",
                            "HOTA": float(rng.uniform(30, 70))}) + "\n")
        if with_old_format:
            f.write(repr({"step": 100 * n_rows, "mode": "iters",
                          "total_loss": 0.5}) + "\n")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    w = tmp_path_factory.mktemp("quality")
    rng = np.random.default_rng(11)
    for variant, seeds in RUNS.items():
        for seed in seeds:
            run = w / f"{variant}_s{seed}"
            (run / "val").mkdir(parents=True)
            metrics = {k: float(rng.uniform(10, 90)) for k in
                       ("HOTA", "DetA", "AssA", "MOTA", "IDF1", "LocA")}
            with open(run / "val" / f"checkpoint_{EPOCHS - 1}_metrics.json",
                      "w") as f:
                json.dump(metrics, f)
            if variant != "windowed_transplant_distill":
                _scalars(str(run / "train" / "scalars.jsonl"), rng,
                         int(rng.integers(3, 30)), seed == 43)
    (w / "stray_dir").mkdir()            # not <variant>_s<seed>: skipped
    return w


def _run(mod, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", argv)
    mod.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--md"]])
def test_quality_report_matches_jax(workdir, extra, capsys, monkeypatch,
                                    tmp_path):
    outs = {}
    for tag, mod in (("jax", _jax_tool("quality_report")),
                     ("port", quality_report)):
        out_json = str(tmp_path / f"{tag}.json")
        outs[tag] = (_run(mod, ["quality_report.py", str(workdir), out_json]
                          + extra, capsys, monkeypatch),
                     json.load(open(out_json)))
    assert outs["port"] == outs["jax"]
    text, agg = outs["port"]
    assert "noise bar" in text and "paired  windowed_transplant_distill" \
        in text and "- windowed_transplant " in text
    assert ("| Variant |" in text) == bool(extra)
    assert set(agg) == set(RUNS)


@pytest.mark.parametrize("tag_filter", ["", "loss", "HOTA"])
def test_scalars_report_matches_jax(workdir, tag_filter, capsys,
                                    monkeypatch):
    for run in ("windowed_s43", "deformable_w256_s42"):
        path = str(workdir / run / "train" / "scalars.jsonl")
        argv = ["scalars_report.py", path] + ([tag_filter] if tag_filter
                                              else [])
        want = _run(_jax_tool("scalars_report"), argv, capsys, monkeypatch)
        got = _run(scalars_report, argv, capsys, monkeypatch)
        assert got == want
        assert got.strip()
    rows = scalars_report.load(path)
    assert rows == _jax_tool("scalars_report").load(path)
    assert scalars_report.sparkline([3.0, 1.0, 2.0] * 30) == \
        _jax_tool("scalars_report").sparkline([3.0, 1.0, 2.0] * 30)
