"""Repeat ``chip_smoke.py`` phase 22's training run on an NVIDIA GPU and
read how far its trained model's first-frame detection scores move from
run to run, against a parent commit's checkout, in turns.

The machine with the card may have no git, so unpack the parent first
into a git-ignored directory::

    mkdir -p outputs/parent
    git archive <parent> | tar -x -C outputs/parent
    python3 scripts/entry_score_spread.py --parent outputs/parent [--runs 2]

Each checkout's package runs in a process of its own (both are named
``memotr_tpu_torch``), in the order parent, this checkout, this checkout,
parent; without ``--parent``, this checkout twice.  A process builds its
package's kernels, then ``--runs`` times, each in a fresh directory, makes
phase 22's inputs (``chip_smoke.entry_inputs``: the seeded DanceTrack tree
and random weights), trains as phase 22 does (``chip_smoke.run_entry``:
configs/train_dancetrack.yaml, 18 bf16 steps over 2 epochs, every step's
K1 launches checked) and reads ``checkpoint_1.pth``'s detections on the
first val frame (``chip_smoke.entry_first_frame``): the best score, the
detections above ``chip_smoke.ENTRY_THRESH`` and the epochs' losses.  The
inputs and the seed are the same in every run; only the order in which the
card sums (K1 backward's and cuDNN's) differs.  ``chip_smoke.py`` is always
this checkout's, so both packages run the same driver.

Prints the card's name and power limit, one JSON line per run, and a last
JSON line with every run in run order.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = module
    spec.loader.exec_module(module)
    return module


def child(package_root: str, runs: int, label: str) -> None:
    sys.path.insert(0, os.path.abspath(package_root))
    import torch
    c = load_chip_smoke()
    from memotr_tpu_torch.config import yaml_to_dict
    assert os.path.dirname(__import__("memotr_tpu_torch").__file__) == \
        os.path.join(os.path.abspath(package_root), "memotr_tpu_torch")
    device = torch.device("cuda", 0)
    c.phase_build()
    val = c.ENTRY_VIDEOS["val"][0][0]
    for i in range(runs):
        with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
            root, yaml_path, _, common = c.entry_inputs(tmp)
            cfg = yaml_to_dict(yaml_path)
            out = os.path.join(tmp, "run")
            c.run_entry(common + ["--mode", "train", "--outputs-dir", out],
                        device, c.entry_per_frame(cfg))
            with open(os.path.join(out, "train", "scalars.jsonl")) as f:
                losses = [json.loads(line)["total_loss"] for line in f]
            det = c.entry_first_frame(
                cfg, os.path.join(out, "checkpoint_1.pth"),
                os.path.join(root, "DanceTrack", "val", val), device)
        scores = sorted(det["scores"].tolist(), reverse=True)
        print(json.dumps({
            "tree": label, "run": i, "best_score": scores[0],
            "above_thresh": sum(s > c.ENTRY_THRESH for s in scores),
            "top5": scores[:5], "epoch_total_loss": losses}), flush=True)


def main():
    p = argparse.ArgumentParser("entry_score_spread")
    p.add_argument("--parent", default=None)
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    p.add_argument("--label", default="", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        child(args.child, args.runs, args.label)
        return
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    order = [("change", ROOT), ("change", ROOT)]
    if args.parent:
        order = [("parent", args.parent)] + order + [("parent", args.parent)]
    rows = []
    for label, tree in order:
        got = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             "--runs", str(args.runs), "--label", label], cwd=ROOT,
            capture_output=True, text=True)
        sys.stderr.write(got.stderr[-4000:])
        if got.returncode:
            sys.stdout.write(got.stdout[-4000:])
            raise SystemExit(f"{label} ({tree}) failed: {got.returncode}")
        for line in got.stdout.splitlines():
            if line.startswith('{"tree"'):
                print(line, flush=True)
                rows.append(json.loads(line))
    print(json.dumps(rows), flush=True)


if __name__ == "__main__":
    main()
