"""Readings of a cell's check on several seeds, with its control: the
program's numbers and those of the reference computed in float8 in the
program's place, on the same inputs.  The limits in
``benchmark/limits/<workload>.json`` are set from these readings.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \\
        --seconds <s> [--out chiprun_out/control_<name>.jsonl]

One process: set-up, a short window and the check for each seed in turn,
on the GPU.  Each seed's line: the program's readings, the control's, and
the run's end-to-end metrics.  With ``--fault <name>`` a fault of
``benchmark/faults.py`` (``faults.FAULTS``: its own and those of
``benchmark/planted/``) is planted in the program and its readings are
taken instead (no control).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    ap.add_argument("--fault", help="a fault of benchmark/faults.py or "
                    "benchmark/planted/ to "
                    "plant in the program (its readings, not the control's)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    from benchmark import faults, harness
    out = open(args.out, "a") if args.out else None
    patches = faults.Patches()
    if args.fault:
        faults.FAULTS[args.fault](patches)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             torch.device("cuda", 0),
                             control=not args.fault)
        line = {"workload": args.workload, "seed": seed,
                "fault": args.fault,
                "program": {k: v["value"] for k, v in r["checks"].items()},
                "control": r.get("control"),
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "attempted": r["attempted"], "failed": r["failed"]}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    patches.undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
