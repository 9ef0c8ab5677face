"""One run of one cell: find the cell, its configuration and its traffic by
name, drive the program, check its outputs, read the metrics and print the
result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
the configuration's file (its ``file``), the traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``driver`` picks one of
``drivers.DRIVERS``), the limits of the check
(``benchmark/limits/<workload>.json``) and one reader a metric
(``benchmark/metrics/<metric name>.py``, whose ``read(run)`` returns the
number or None where it finds nothing to read).  The configuration's
``ENCODER_TYPE`` picks the reference's encoder part
(``benchmark/reference/models/encoders/<ENCODER_TYPE>.py``), and the faults
that can touch it (``faults.applies``) include those of
``benchmark/planted/<fault>.py``.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import check, drivers

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "memotr_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, bench: Dict) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(cell_: Dict, bench: Dict, root: Path = ROOT) -> Dict:
    for c in bench["configs"]:
        if c["name"] == cell_["config"]:
            return load_json(root / c["file"])["config"]
    raise KeyError(f"no config {cell_['config']!r} in BENCHMARK.json")


def traffic_of(cell_: Dict) -> Dict:
    return load_json(HERE / "traffic" / f"{cell_['traffic']}.json")


def limits_of(name: str) -> Dict[str, float]:
    path = HERE / "limits" / f"{name}.json"
    return load_json(path)["limits"] if path.exists() else {}


def metrics_for(name: str, kind: str, bench: Dict) -> List[Dict]:
    """The metrics of ``kind`` (``end_to_end`` / ``per_layer``) a cell
    reports: those without ``workloads`` and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    mod_name = "benchmark.metrics._" + metric.replace(".", "_").replace("-", "_")
    if mod_name not in sys.modules:
        sp = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(sp)
        sys.modules[mod_name] = mod
        sp.loader.exec_module(mod)
    return sys.modules[mod_name].read


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


def device_info(run: drivers.Run) -> Dict:
    if run.device.type == "cuda":
        kind = torch.cuda.get_device_name(run.device)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": 1,
            "memory_peak_bytes": max(run.memory_peak, run.window_peak)}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them (a card
    below its 700 W runs slower under load), or why it could not."""
    import subprocess
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not run: {e}"
    return p.stdout.strip() or p.stderr.strip()


def notes(run: drivers.Run) -> List[str]:
    """Lines printed before the result: the card and its power limit."""
    return [f"card: {power_limit()}"] if run.device.type == "cuda" else []


def breakdown(run: drivers.Run) -> Optional[Dict]:
    from . import trace
    if not run.events:
        return None
    spans = [(e["name"][len("bench."):], e["ts"], e["ts"] + e["dur"])
             for e in run.events if e["kind"] == "range"
             and e["name"].startswith("bench.") and e["name"] != "bench.window"]
    return {"device_ops": trace.top_device_ops(run.events, run.trace_window),
            "idle_gaps": trace.idle_gaps(run.events, run.trace_window, spans)}


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: torch.device, bench: Optional[Dict] = None,
             config_overrides: Optional[Dict] = None,
             traffic_overrides: Optional[Dict] = None,
             control: bool = False) -> Dict:
    """Run a cell once and return its result (the printed line's object,
    with ``checks`` last).  The overrides serve the tests,
    which run the cell at a small size on the CPU.  ``control``: also read
    the control (the reference in float8 in the program's place) on the
    same inputs, under ``result["control"]``."""
    bench = bench or spec()
    c = cell(workload, bench)
    config = dict(config_of(c, bench), **(config_overrides or {}))
    traffic = dict(traffic_of(c), **(traffic_overrides or {}))
    run = drivers.Run(workload=workload, config=config, traffic=traffic,
                      seed=seed, seconds=seconds, traced=traced,
                      device=device)
    drivers.DRIVERS[traffic["driver"]](run)
    if run.device.type == "cuda":
        run.memory_peak = max(run.memory_peak, run.window_peak)

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in metrics_for(workload, kind, bench):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device_info(run)}
    if traced:
        from . import trace
        result["device"]["window_s"] = (run.trace_window[1]
                                        - run.trace_window[0]) / 1e6
        result["device"]["busy_s"] = trace.busy_us(
            run.events or [], run.trace_window) / 1e6
        result["breakdown"] = breakdown(run)
    run.events = None

    check.free_device()
    readings = check.check_stream(run)
    lim = limits_of(workload)
    correct = check.judge(readings, lim) and run.failed == 0 and all(
        math.isfinite(v["value"]) for v in metrics.values())
    result = {"correct": bool(correct), **result}
    if control:
        check.free_device()
        result["control"] = check.control_stream(run)
    result["checks"] = {k: {"value": v, "limit": lim.get(k)}
                        for k, v in readings.items()}
    for line in notes(run):
        print(line, file=sys.stderr, flush=True)
    return result


def emit(result: Dict) -> None:
    """The numbers compared beside their limits as the last lines on
    standard error, and the result as the last line on standard output."""
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
