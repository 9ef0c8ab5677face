"""Logging and sliding-window metrics (counterpart of
``memotr_tpu/log/logger.py``).

``Logger`` prints to the console and appends to files under its log
directory: ``log.txt``, a YAML file (the resolved ``config.yaml``) and the
``scalars.jsonl`` stream, one JSON record of averaged metrics per line.
``MetricLog`` keeps a ``Value`` (sliding window of 100 and a global
average) per metric name; in a process group ``MetricLog.sync`` sums each
metric's ``(total_sum, total_count)`` over the ranks, as the JAX package's
``process_allgather`` does.  A ``Logger`` writes and prints on rank 0
only.  ``yaml`` is imported on first use.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict, deque
from typing import Dict

import numpy as np

from ..utils.distributed import is_main_process, sum_over_ranks


class Value:
    """Sliding window (100) and global average."""

    def __init__(self, window_size: int = 100):
        self.window = deque(maxlen=window_size)
        self.total_sum = 0.0
        self.total_count = 0

    def update(self, value: float):
        v = float(value)
        self.window.append(v)
        self.total_sum += v
        self.total_count += 1

    @property
    def avg(self) -> float:
        return float(np.mean(self.window)) if self.window else 0.0

    @property
    def global_avg(self) -> float:
        return self.total_sum / max(1, self.total_count)


class MetricLog:
    def __init__(self):
        self.metrics: Dict[str, Value] = defaultdict(Value)

    def update(self, name: str, value: float):
        self.metrics[name].update(value)

    def sync(self):
        """Each metric's global totals: ``(total_sum, total_count)`` summed
        over the process group (nothing to do in one process)."""
        totals = sum_over_ranks({n: (v.total_sum, v.total_count)
                                 for n, v in self.metrics.items()})
        for n, (total, count) in totals.items():
            self.metrics[n].total_sum = total
            self.metrics[n].total_count = count

    def __str__(self):
        return ", ".join(f"{k}={v.avg:.4f}" for k, v in
                         sorted(self.metrics.items()))


class Logger:
    def __init__(self, logdir: str):
        self.logdir = logdir
        self.enabled = is_main_process()
        if self.enabled:
            os.makedirs(logdir, exist_ok=True)

    def show(self, head: str = "", log=None):
        if self.enabled:
            print(f"{head} {log if log is not None else ''}".strip(),
                  flush=True)

    def write(self, log, filename: str = "log.txt", mode: str = "a",
              head: str = ""):
        if not self.enabled:
            return
        with open(os.path.join(self.logdir, filename), mode) as f:
            if filename.endswith(".yaml"):
                import yaml
                yaml.dump(log, f, allow_unicode=True)
            elif filename.endswith((".json", ".jsonl")):
                f.write(json.dumps(log) + "\n")
            else:
                f.write(f"{head} {log}\n")

    def scalars(self, tag_values: Dict[str, float], step: int,
                mode: str = "iters"):
        """Appends one record to ``scalars.jsonl``."""
        rec = {"step": step, "mode": mode}
        rec.update({k: float(v) for k, v in tag_values.items()})
        self.write(rec, filename="scalars.jsonl", mode="a")

    def metric_log(self, log: MetricLog, step: int, mode: str = "iters"):
        self.scalars({k: v.avg for k, v in log.metrics.items()}, step, mode)
