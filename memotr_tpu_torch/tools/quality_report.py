"""Aggregate seed-replicated proxy runs into a mean +- std report: the
port's copy of ``tools/quality_report.py``, with the same output.

Reads every ``<workdir>/<variant>_s<seed>/val/checkpoint_<E>_metrics.json``
that ``memotr_tpu_torch.tools.flagship_eval`` writes (``engine/eval.py``
names them as the JAX package does), groups by variant, and prints a table
with mean, std and n per metric, plus the noise bar (the largest
per-variant std: the smallest effect one comparison resolves is ~2x
that), the paired same-seed deltas and, with ``--md``, a markdown table.

Usage: python -m memotr_tpu_torch.tools.quality_report <workdir> [out.json] [--md]
"""
from __future__ import annotations

import glob
import json
import os
import re
import sys

import numpy as np

METRICS = ("HOTA", "DetA", "AssA", "MOTA", "IDF1")
AGG_KEYS = METRICS + ("final_loss",)


def _final_loss(run_dir: str):
    """Last logged total_loss from the run's train scalar stream (window-
    averaged) — pairs the HOTA row with optimization evidence (the windowed
    encoder's deficits have repeatedly been optimization-, not capacity-,
    limited; QUALITY.md)."""
    path = os.path.join(run_dir, "train", "scalars.jsonl")
    last = None
    try:
        with open(path) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if row.get("mode") == "iters" and "total_loss" in row:
                    last = float(row["total_loss"])
    except OSError:
        return None
    return last


def collect(workdir: str) -> dict:
    runs = {}
    for path in sorted(glob.glob(os.path.join(
            workdir, "*_s*", "val", "checkpoint_*_metrics.json"))):
        run_dir = os.path.dirname(os.path.dirname(path))
        run = os.path.basename(run_dir)
        m = re.match(r"(.+)_s(\d+)$", run)
        if not m:
            continue
        variant, seed = m.group(1), int(m.group(2))
        with open(path) as f:
            metrics = json.load(f)
        entry = {k: float(metrics[k]) for k in METRICS if k in metrics}
        loss = _final_loss(run_dir)
        if loss is not None:
            entry["final_loss"] = loss
        runs.setdefault(variant, {})[seed] = entry
    return runs


def aggregate(runs: dict) -> dict:
    out = {}
    for variant, by_seed in sorted(runs.items()):
        agg = {"n": len(by_seed), "seeds": sorted(by_seed)}
        for k in AGG_KEYS:
            vals = [v[k] for v in by_seed.values() if k in v]
            if vals:
                agg[k] = {"mean": round(float(np.mean(vals)), 2),
                          "std": round(float(np.std(vals, ddof=1)), 2)
                          if len(vals) > 1 else 0.0,
                          "values": [round(v, 2) for v in vals]}
        out[variant] = agg
    return out


def main():
    workdir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/flagship_eval"
    agg = aggregate(collect(workdir))
    hdr = f"{'variant':32s} {'n':>2s}  " + "  ".join(
        f"{k:>12s}" for k in ("HOTA", "DetA", "AssA", "final_loss"))
    print(hdr)
    stds = []
    for variant, a in sorted(agg.items(),
                             key=lambda kv: -kv[1].get("HOTA", {})
                             .get("mean", 0)):
        row = f"{variant:32s} {a['n']:2d}  "
        for k in ("HOTA", "DetA", "AssA", "final_loss"):
            if k in a:
                row += f"{a[k]['mean']:6.2f}+-{a[k]['std']:4.2f}  "
                if k == "HOTA" and a["n"] > 1:
                    stds.append(a[k]["std"])
        print(row)
    if stds:
        print(f"\nnoise bar: max per-variant HOTA std = {max(stds):.2f} "
              f"(min detectable single-pair effect ~{2 * max(stds):.1f})")

    # Paired same-seed deltas: "<base>_<lever>" vs "<base>" on the shared
    # seeds.  Pairing removes the between-seed variance component, so lever
    # effects are resolvable well below the unpaired noise bar.
    runs = collect(workdir)
    done = set()

    def paired(variant, base):
        if (variant, base) in done or variant not in runs or base not in runs:
            return
        done.add((variant, base))
        shared = sorted(set(runs[variant]) & set(runs[base]))
        if not shared:
            return
        d = [runs[variant][s]["HOTA"] - runs[base][s]["HOTA"]
             for s in shared]
        mean = float(np.mean(d))
        sd = float(np.std(d, ddof=1)) if len(d) > 1 else 0.0
        print(f"paired  {variant:28s} - {base:24s} "
              f"(seeds {shared}): dHOTA = {mean:+.2f}"
              + (f" +- {sd:.2f}" if len(d) > 1 else ""))

    for variant in sorted(runs):
        for base in sorted(runs, key=len, reverse=True):
            if base != variant and variant.startswith(base + "_"):
                paired(variant, base)
                break
    # cross-family pairs the prefix rule cannot see: the student-above-
    # teacher claims (transplant vs its distillation TEACHER) and the
    # hybrid-vs-flagship serving tradeoff
    for variant, base in (("windowed_transplant", "deformable"),
                          ("windowed_w256", "deformable_w256"),
                          ("windowed_w256_transplant", "deformable_w256"),
                          ("hybrid_w256_transplant",
                           "windowed_w256_transplant")):
        paired(variant, base)
    if "--md" in sys.argv:
        print()
        print(markdown_table(agg))
    out = [a for a in sys.argv[1:] if a.endswith(".json")]
    if out:
        with open(out[0], "w") as f:
            json.dump(agg, f, indent=1)


def markdown_table(agg: dict) -> str:
    """QUALITY.md-ready table of the aggregated rows, HOTA-descending."""
    lines = ["| Variant | n | HOTA | DetA | AssA | final loss |",
             "|---|---|---|---|---|---|"]
    for variant, a in sorted(agg.items(),
                             key=lambda kv: -kv[1].get("HOTA", {})
                             .get("mean", 0)):
        cells = [variant, str(a["n"])]
        for k in ("HOTA", "DetA", "AssA", "final_loss"):
            cells.append(f"{a[k]['mean']:.1f} ± {a[k]['std']:.1f}"
                         if k in a else "—")
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
