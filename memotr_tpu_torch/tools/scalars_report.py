"""Summarize a training/eval scalar stream (``scalars.jsonl``): the port's
copy of ``tools/scalars_report.py``, with the same output.

Reads the JSONL scalar stream that the port's ``Logger.scalars`` writes
(``<run>/train/scalars.jsonl``, ``<run>/val/scalars.jsonl``) and prints,
per tag, the first/last/min/max values and an ASCII sparkline: enough to
check a loss curve or an eval metric over checkpoints without a GUI.

Usage: python -m memotr_tpu_torch.tools.scalars_report <path/to/scalars.jsonl> [tag-filter]
"""
from __future__ import annotations

import ast
import json
import sys
from collections import defaultdict

BARS = " .:-=+*#%@"


def load(path: str):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                # tolerate the pre-fix repr format
                rows.append(ast.literal_eval(line))
    return rows


def sparkline(vals, width: int = 40) -> str:
    if not vals:
        return ""
    if len(vals) > width:
        stride = len(vals) / width
        vals = [vals[int(i * stride)] for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(BARS[int((v - lo) / span * (len(BARS) - 1))] for v in vals)


def main():
    path = sys.argv[1]
    tag_filter = sys.argv[2] if len(sys.argv) > 2 else ""
    series = defaultdict(list)
    for row in load(path):
        step = row.get("step", 0)
        for k, v in row.items():
            if k in ("step", "mode") or not isinstance(v, (int, float)):
                continue
            if tag_filter and tag_filter not in k:
                continue
            series[k].append((step, float(v)))

    name_w = max((len(k) for k in series), default=4)
    for k in sorted(series):
        vals = [v for _, v in sorted(series[k])]
        print(f"{k:<{name_w}}  first={vals[0]:>10.4g} last={vals[-1]:>10.4g} "
              f"min={min(vals):>10.4g} max={max(vals):>10.4g}  "
              f"|{sparkline(vals)}|")


if __name__ == "__main__":
    main()
