"""Run one cell of the benchmark of ``memotr_tpu_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU.  Prints one
JSON object as the last line of standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, then ``checks``: each number compared with its limit)
and the compared numbers as the last lines of standard error.  Exits with
a code other than 0, printing no result, without a CUDA device, when the
program cannot be imported, or when a JAX module was loaded.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    chips = harness.cell(args.workload, harness.spec())["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: no CUDA device, or fewer than the {chips} the cell "
              f"asks for; the benchmark runs only on the GPU",
              file=sys.stderr)
        return 2
    import memotr_tpu_torch  # noqa: F401  (fails in a tree without it)

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0))
    banned = harness.banned_modules()
    if banned:
        print(f"run.py: modules of JAX or the JAX package were loaded: "
              f"{banned}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
