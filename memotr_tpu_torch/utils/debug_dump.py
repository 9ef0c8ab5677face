"""Debug-by-artifact: dump intermediate tensors for offline inspection
(counterpart of ``memotr_tpu/utils/debug_dump.py``).

``VISUALIZE`` writes, one compressed ``.npz`` a frame, what a step
returns: on the submit path each frame's results and post-update
``TrackState``, on the training path each iteration's per-frame decoder
outputs and track state (``engine/trainer.clip_loss``).  Keys are the JAX
package's: a dict's entries are ``<name>.<key>`` (nested dicts joined by
dots), a ``TrackState``'s fields ``<name>.<field>``, a tensor ``<name>``.

Usage (streaming):
    dumper = DebugDumper("outputs/visualize", enabled=config["VISUALIZE"])
    ...
    dumper.dump_frame(i, results=results, state=state)
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(prefix: str, tree: Any, out: Dict[str, np.ndarray]) -> None:
    """Tensors and arrays under their dotted path; anything else is
    skipped, as the JAX package skips what is not an array."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _flatten(f"{prefix}.{f.name}", getattr(tree, f.name), out)
    elif hasattr(tree, "shape"):
        out[prefix] = _host(tree)


class DebugDumper:
    """Writes ``out_dir/frame_{i:06d}.npz`` per ``dump_frame`` call when
    ``enabled``; does nothing otherwise."""

    def __init__(self, out_dir: str, enabled: bool = False):
        self.out_dir = out_dir
        self.enabled = enabled
        if enabled:
            os.makedirs(out_dir, exist_ok=True)

    def dump_frame(self, frame_idx: int, **named_trees) -> None:
        if not self.enabled:
            return
        arrays: Dict[str, np.ndarray] = {}
        for name, tree in named_trees.items():
            _flatten(name, tree, arrays)
        np.savez_compressed(
            os.path.join(self.out_dir, f"frame_{frame_idx:06d}.npz"),
            **arrays)
