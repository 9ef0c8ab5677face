"""Evaluation entry (counterpart of ``memotr_tpu/engine/eval.py``): submit
on the eval split, then score, in one process.

The submit is the port's ``engine.submit.submit`` (on the GPU unless the
caller asks for the CPU); the metrics are the port's own copy of the JAX
package's (``metrics/``: HOTA, CLEAR, Identity, VACE, IDEucl, Count).
Modes (``EVAL_MODE``):

- ``specific``: one checkpoint, ``EVAL_DIR/EVAL_MODEL``;
- ``continue``: the epoch checkpoints ``EVAL_DIR/checkpoint_<i>.pth`` in
  order as training writes them (polled every 30 s), up to ``EPOCHS``,
  with an ``eval_states.yaml`` cursor in ``EVAL_DIR``.

A checkpoint's outputs are named after its file's stem, as the JAX
package names them after its checkpoint directory: for
``checkpoint_1.pth``, the tracker directory ``<split>/checkpoint_1_tracker/``
(with ``pedestrian_summary.txt``), ``<split>/checkpoint_1_metrics.json``,
and a ``scalars.jsonl`` record at step 1 (the epoch) in mode ``epochs``.

In a process group every rank submits its share of the sequences, all
wait at a barrier, and rank 0 alone renames the tracker directory and
scores it: JAX's ``eval_model`` scores right after its own shard, so it
can read a directory another process has not finished writing (ROADMAP
hazard (c)).  The other ranks return None; ``continue``'s cursor is rank
0's.
"""
from __future__ import annotations

import os
import shutil
import time
from typing import Dict, Optional

import torch

from ..config import yaml_to_dict
from ..log.logger import Logger
from ..metrics import evaluate_mot_challenge
from ..metrics.evaluator import write_summary
from ..utils.distributed import barrier, is_main_process
from .submit import check_options, resolve_device, submit

SUMMARY_KEYS = ("HOTA", "DetA", "AssA", "MOTA", "IDF1")
POLL_SECONDS = 30


def checkpoint_epoch(stem: str) -> int:
    """The epoch of ``checkpoint_<e>`` (0 for any other name)."""
    tail = stem.rsplit("_", 1)[-1]
    return int(tail) if tail.isdigit() else 0


def eval_model(config: dict, eval_dir: str, model_name: str, logger: Logger,
               device: torch.device | str = "cuda"
               ) -> Optional[Dict[str, float]]:
    """Submits ``eval_dir/model_name`` on ``EVAL_DATA_SPLIT`` and scores it
    against the split's GT once every rank's shard is written; returns the
    metric dict (percent) on rank 0, None on the others."""
    split = config["EVAL_DATA_SPLIT"]
    submit(dict(config, SUBMIT_DIR=eval_dir, SUBMIT_MODEL=model_name,
                SUBMIT_DATA_SPLIT=split), device)
    barrier()
    if not is_main_process():
        return None

    dataset = yaml_to_dict(os.path.join(eval_dir, "train/config.yaml"))[
        "DATASET"]
    stem = os.path.splitext(model_name)[0]
    named_dir = os.path.join(eval_dir, split, f"{stem}_tracker")
    if os.path.isdir(named_dir):
        shutil.rmtree(named_dir)
    os.rename(os.path.join(eval_dir, split, "tracker"), named_dir)

    root = config["DATA_ROOT"]
    if dataset in ("DanceTrack", "SportsMOT"):
        gt_dir = os.path.join(root, dataset, split)
    else:
        gt_dir = os.path.join(root, dataset, "images", split)
    # a seqmap, where the split has one, selects the sequences scored
    seqmap = os.path.join(root, dataset, f"{split}_seqmap.txt")
    metrics = evaluate_mot_challenge(
        gt_dir, named_dir, dataset=dataset,
        num_parallel=int(config.get("EVAL_THREADS", 8) or 8),
        seqmap_file=seqmap if os.path.isfile(seqmap) else None)
    write_summary(metrics, os.path.join(named_dir, "pedestrian_summary.txt"))
    logger.show(head=f"[eval {stem}]",
                log={k: round(v, 3) for k, v in metrics.items()
                     if k in SUMMARY_KEYS})
    logger.write({k: float(v) for k, v in metrics.items()},
                 filename=f"{stem}_metrics.json", mode="w")
    logger.scalars({k: float(v) for k, v in metrics.items()
                    if isinstance(v, (int, float))},
                   step=checkpoint_epoch(stem), mode="epochs")
    return metrics


def _eval_all_ranks(config, eval_dir, name, logger, device):
    """``eval_model``, then a barrier: no rank goes on (to the next
    checkpoint's submit, which writes the tracker directory again) before
    rank 0 has moved and scored this one."""
    metrics = eval_model(config, eval_dir, name, logger, device)
    barrier()
    return metrics


def evaluate(config: dict, device: torch.device | str = "cuda"
             ) -> Optional[Dict[str, float]]:
    """``EVAL_MODE`` ``specific``: the metrics of ``EVAL_MODEL``;
    ``continue``: None, once ``checkpoint_<EPOCHS - 1>.pth`` is scored."""
    check_options(config)
    device = resolve_device(device)
    eval_dir = config["EVAL_DIR"]
    logger = Logger(logdir=os.path.join(eval_dir, config["EVAL_DATA_SPLIT"]))
    mode = config.get("EVAL_MODE", "specific")
    if mode == "specific":
        assert config.get("EVAL_MODEL"), "--eval-model required"
        return _eval_all_ranks(config, eval_dir, config["EVAL_MODEL"],
                               logger, device)
    if mode != "continue":
        raise ValueError(f"Unknown EVAL_MODE '{mode}'")
    import yaml
    states_path = os.path.join(eval_dir, "eval_states.yaml")
    states = {"last": -1}
    if os.path.exists(states_path):
        with open(states_path) as f:
            states.update(yaml.safe_load(f) or {})
    while states["last"] + 1 < config["EPOCHS"]:
        name = f"checkpoint_{states['last'] + 1}.pth"
        if os.path.isfile(os.path.join(eval_dir, name)):
            _eval_all_ranks(config, eval_dir, name, logger, device)
            states["last"] += 1
            if is_main_process():
                with open(states_path, "w") as f:
                    yaml.dump(states, f)
        else:
            time.sleep(POLL_SECONDS)
    return None
