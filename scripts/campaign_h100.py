"""The proxy-v3 quality campaign of the port on one card:
``memotr_tpu_torch.tools.flagship_eval`` runs, several at a time.

    python3 scripts/campaign_h100.py <workdir> <out> \
        [--teachers 42,43] [--students windowed_w256_transplant:42,...] \
        [--epochs 10] [--stop-after SECONDS] \
        [--pack-teacher FILE] [--unpack-teacher FILE]

Generates the v3 world once (``PROXY_VERSION=3``: 8 train and 8 val
sequences of 96 frames), then runs each ``deformable_w256`` teacher of
``--teachers`` at once and, once they have ended, each run of
``--students`` at once.  Every run is the tool's own ``launch`` (one
``flagship_eval --single`` process) under the tool's stop policy
(``run_timeout``): the hard stop is ``--stop-after`` seconds after the
start, less the time kept for the reports; a run still going then is
killed, and its epoch checkpoints stay in the workdir for a later run to
resume.  Then ``quality_report`` (``<out>/quality.json``, ``--md``) and
``scalars_report`` over the workdir, and into ``<out>``: each run's log,
its metrics, ``scalars.jsonl`` files and ``config.yaml``, and
``summary.json``: per run its exit code, wall seconds, metrics, peak
memory, TF32 settings and host ms an iteration at T=2 and T=3 (the
medians of the training log's 100-iteration windows), and the card's
utilization sampled by ``nvidia-smi`` every 5 s.

Where each run of this script is a fresh machine whose copied-back
output is capped at 64 MiB, a teacher's ``checkpoint_<E>.pth`` (144 MiB
of float32 weights) does not fit, so the seed-42 teacher crosses from the
run that trains it to the run of its students as ``--pack-teacher
<file>``: every tensor of its ``"model"`` rounded to
bfloat16 (round to nearest even), byte-planes split and zlib-compressed
(~50 MiB), with its ``"states"``; ``--unpack-teacher <file>`` writes it
back as the teacher's ``checkpoint_<E>.pth`` (float32) before the students
start.  The run that packs also scores the unpacked copy as the run
``deformable_w256_bf16_s42``, beside the teacher's own row: what the
rounding costs the teacher.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import zlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from memotr_tpu_torch.tools import flagship_eval as fe  # noqa: E402

TEACHER = "deformable_w256"
REPORT_SECONDS = 120      # left at the end for the reports and copies


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class Sampler(threading.Thread):
    """``nvidia-smi`` GPU utilization and memory used, every 5 s."""

    def __init__(self):
        super().__init__(daemon=True)
        self.rows, self.stop = [], threading.Event()

    def run(self):
        while not self.stop.wait(5.0):
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=utilization.gpu,memory.used",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True).stdout.split(",")
            if len(out) == 2:
                self.rows.append((time.time(), float(out[0]),
                                  float(out[1])))

    def mean_util(self, t0: float, t1: float):
        u = [r[1] for r in self.rows if t0 <= r[0] <= t1]
        return sum(u) / len(u) if u else None


def run_one(workdir, epochs, name, seed, logs, hard_stop, sampler, done):
    """One run through the tool's ``launch`` under its ``run_timeout``;
    its numbers into ``done``."""
    key = f"{name}_s{seed}"
    timeout = fe.run_timeout(hard_stop, time.time())
    if timeout is None:
        print(f"!!! hard stop imminent, skipping {key}", flush=True)
        return
    log_path = os.path.join(logs, f"{key}.log")
    print(f"=== started {key}", flush=True)
    t0 = time.time()
    with open(log_path, "w") as log:
        try:
            rc = fe.launch(workdir, epochs, name, seed, "cuda", timeout, log)
        except subprocess.TimeoutExpired:
            rc = "killed at the hard stop"
    t1 = time.time()
    line = run_line(log_path) or {}
    done[key] = {"rc": rc, "seconds": t1 - t0,
                 "gpu_util_mean": sampler.mean_util(t0, t1),
                 **{k: line.get(k) for k in ("metrics", "peak_gib", "tf32")}}
    print(f"=== {key} ended rc={rc} after {t1 - t0:.0f} s: "
          f"{line.get('metrics')}", flush=True)


def run_all(runs, workdir, epochs, logs, hard_stop, sampler, done):
    """``run_one`` for every (name, seed) of ``runs``, all at once."""
    threads = [threading.Thread(target=run_one, args=(
        workdir, epochs, name, seed, logs, hard_stop, sampler, done))
        for name, seed in runs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def run_line(log_path: str):
    """The ``--single`` JSON line of a run's log, or None."""
    with open(log_path) as f:
        for line in f:
            if line.startswith('{"run"'):
                return json.loads(line)
    return None


def iteration_ms(scalars: str, epochs: int) -> dict:
    """Medians of the training log's 100-iteration windows of host ms an
    iteration, by clip length T (each epoch's T and iterations from
    ``flagship_eval.epoch_iterations``); each epoch's first row (one
    iteration) left out."""
    bounds, first = [], 0
    for t, n in fe.epoch_iterations(epochs):
        bounds.append((t, first, first + n))
        first += n
    by_t = {}
    with open(scalars) as f:
        for line in f:
            row = json.loads(line)
            if row.get("mode") != "iters" or "time per iter" not in row:
                continue
            for t, lo, hi in bounds:
                if lo < row["step"] < hi:
                    by_t.setdefault(t, []).append(row)
    out = {}
    for t, rows in sorted(by_t.items()):
        ms = sorted(1e3 * r["time per iter"] for r in rows)
        out[f"T{t}"] = {"ms": ms[len(ms) // 2], "windows": len(ms),
                        "wait_ms": sum(1e3 * r["data wait"] for r in rows)
                        / len(rows)}
    return out


def pack_teacher(pth: str, path: str) -> dict:
    """``pth``'s model as bfloat16 into ``path`` (see the module's
    docstring); returns the sizes."""
    import io

    import numpy as np
    import torch
    ckpt = torch.load(pth, map_location="cpu", weights_only=True)
    index, halves, other = [], [], {}
    for k, v in ckpt["model"].items():
        if v.is_floating_point():
            h = v.to(torch.bfloat16).view(torch.int16).numpy().reshape(-1)
            index.append([k, list(v.shape), int(h.size)])
            halves.append(h)
        else:
            other[k] = v
    planes = np.concatenate(halves).view(np.uint8).reshape(-1, 2).T
    extra = io.BytesIO()
    torch.save({"other": other, "states": ckpt.get("states", {})}, extra)
    head = json.dumps({"index": index, "extra": len(extra.getvalue())})
    body = zlib.compress(planes.tobytes(), 6)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head.encode())
        f.write(extra.getvalue())
        f.write(body)
    return {"float32_mib": os.path.getsize(pth) / 2 ** 20,
            "packed_mib": os.path.getsize(path) / 2 ** 20}


def unpack_teacher(path: str, pth: str) -> None:
    """``pack_teacher``'s file back into an epoch checkpoint ``pth`` of
    the port (float32 model, its states)."""
    import io

    import numpy as np
    import torch
    with open(path, "rb") as f:
        head = json.loads(f.read(int.from_bytes(f.read(8), "little")))
        extra = torch.load(io.BytesIO(f.read(head["extra"])),
                           map_location="cpu", weights_only=True)
        planes = np.frombuffer(zlib.decompress(f.read()), np.uint8)
    halves = planes.reshape(2, -1).T.copy().view(np.int16).reshape(-1)
    model, at = {}, 0
    for k, shape, n in head["index"]:
        model[k] = torch.from_numpy(halves[at:at + n].copy()).view(
            torch.bfloat16).float().reshape(shape)
        at += n
    model.update(extra["other"])
    os.makedirs(os.path.dirname(pth), exist_ok=True)
    torch.save({"model": model, "states": extra["states"]}, pth)


def score_unpacked(workdir: str, packed: str, epochs: int) -> dict:
    """The packed teacher, unpacked, scored as ``deformable_w256_bf16``
    (seed 42) on the val split, beside the teacher's own row."""
    from memotr_tpu_torch.engine.eval import eval_model
    from memotr_tpu_torch.log.logger import Logger
    outdir = fe.run_dir(workdir, f"{TEACHER}_bf16", 42)
    ckpt = f"checkpoint_{epochs - 1}.pth"
    unpack_teacher(packed, os.path.join(outdir, ckpt))
    os.makedirs(os.path.join(outdir, "train"), exist_ok=True)
    shutil.copy(os.path.join(fe.run_dir(workdir, TEACHER, 42), "train",
                             "config.yaml"),
                os.path.join(outdir, "train", "config.yaml"))
    encoder_type, overrides = fe.VARIANTS[TEACHER]
    cfg = fe.base_config(os.path.join(workdir, "data"), outdir,
                         encoder_type, epochs)
    cfg.update(overrides)
    metrics = eval_model(cfg, outdir, ckpt,
                         Logger(logdir=os.path.join(outdir, "val")), "cuda")
    return fe.summary(metrics)


def campaign(args):
    out = os.path.abspath(args.out)
    logs = os.path.join(out, "logs")
    os.makedirs(logs, exist_ok=True)
    workdir = os.path.abspath(args.workdir)
    t_start = time.time()
    hard_stop = t_start + args.stop_after - REPORT_SECONDS
    os.environ["PROXY_VERSION"] = "3"
    import torch
    info = {"card": card(), "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "tf32_defaults": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                              "cudnn": torch.backends.cudnn.allow_tf32}}
    print(json.dumps(info), flush=True)
    t0 = time.time()
    fe.ensure_data(workdir)
    info["data_s"] = time.time() - t0
    print(f"data ready in {info['data_s']:.1f} s", flush=True)

    teacher = fe.teacher_ckpt(workdir, args.epochs, TEACHER)
    if args.unpack_teacher:
        unpack_teacher(args.unpack_teacher, teacher)
        print(f"teacher unpacked from {args.unpack_teacher}", flush=True)
    sampler = Sampler()
    sampler.start()
    done = {}
    common = (workdir, args.epochs, logs, hard_stop, sampler, done)
    run_all([(TEACHER, s) for s in args.teachers], *common)
    if args.students and os.path.isfile(teacher):
        run_all(args.students, *common)
    elif args.students:
        print(f"!!! no seed-42 teacher ({teacher}): no student runs",
              flush=True)
    sampler.stop.set()
    if args.pack_teacher and os.path.isfile(teacher):
        info["packed_teacher"] = pack_teacher(teacher, args.pack_teacher)
        t0 = time.time()
        got = score_unpacked(workdir, args.pack_teacher, args.epochs)
        done[f"{TEACHER}_bf16_s42"] = {"rc": 0, "seconds": time.time() - t0,
                                       "metrics": got}
        print(f"packed teacher {info['packed_teacher']}: HOTA of the "
              f"unpacked copy {got}", flush=True)

    report = [sys.executable, "-m", "memotr_tpu_torch.tools.quality_report",
              workdir, os.path.join(out, "quality.json"), "--md"]
    text = subprocess.run(report, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO)).stdout
    with open(os.path.join(out, "quality_report.txt"), "w") as f:
        f.write(text)
    print(text, flush=True)
    for key, d in done.items():
        run = os.path.join(workdir, key)
        dest = os.path.join(out, "runs", key)
        for sub in ("train", "val"):
            src = os.path.join(run, sub)
            if not os.path.isdir(src):
                continue
            os.makedirs(os.path.join(dest, sub), exist_ok=True)
            for fn in os.listdir(src):
                if fn.endswith((".json", ".jsonl", ".yaml", ".txt")):
                    shutil.copy(os.path.join(src, fn),
                                os.path.join(dest, sub, fn))
        scalars = os.path.join(run, "train", "scalars.jsonl")
        if os.path.isfile(scalars):
            d["iteration_ms"] = iteration_ms(scalars, args.epochs)
            text = subprocess.run(
                [sys.executable, "-m",
                 "memotr_tpu_torch.tools.scalars_report", scalars, "loss"],
                capture_output=True, text=True,
                env=dict(os.environ, PYTHONPATH=REPO)).stdout
            with open(os.path.join(dest, "scalars_report.txt"), "w") as f:
                f.write(text)
    info.update(runs=done, wall_s=time.time() - t_start,
                gpu_samples=len(sampler.rows))
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(info, f, indent=1)
    print(json.dumps(info), flush=True)
    return 0 if all(d["rc"] == 0 for d in done.values()) else 1


def main():
    p = argparse.ArgumentParser("campaign_h100")
    p.add_argument("workdir")
    p.add_argument("out")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--teachers", default="42",
                   type=lambda s: [int(x) for x in s.split(",") if x])
    p.add_argument("--students", default="", type=lambda s: [
        (x.split(":")[0], int(x.split(":")[1])) for x in s.split(",") if x])
    p.add_argument("--stop-after", type=float, default=3300.0)
    p.add_argument("--pack-teacher", default=None)
    p.add_argument("--unpack-teacher", default=None)
    return campaign(p.parse_args())


if __name__ == "__main__":
    sys.exit(main())
