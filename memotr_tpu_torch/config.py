"""Flat UPPER_CASE config access for the PyTorch port.

Same key space and defaults as ``memotr_tpu/config.py`` for the keys the
streaming-inference slice reads.  ``yaml`` is imported only inside
``yaml_to_dict``: the machine that runs the port on the GPU has no PyYAML,
and the slice can be driven from a dict built in code.
"""
from __future__ import annotations

from typing import Any

# Defaults for keys an experiment YAML may omit (memotr_tpu/config.py).
# ``MSDA_IMPL`` and ``TOKEN_SHARD_AXIS`` are TPU dispatch knobs the port
# ignores: one CUDA kernel serves every query count on one device.
_DEFAULTS = {
    "MERGE_DET_TRACK_LAYER": 0,
    "EXTRA_TRACK_ATTN": False,
    "USE_DAB": True,
    "TRACK_SLOTS": 64,
    "DTYPE": "bfloat16",
    "EVAL_SHORT_SIDE": 800,
    "EVAL_MAX_SIDE": 1536,
    "ENCODER_TYPE": "deformable",
}


def cfg_get(config: dict, key: str, default: Any = None) -> Any:
    if key in config and config[key] is not None:
        return config[key]
    if key in _DEFAULTS:
        return _DEFAULTS[key]
    return default


def yaml_to_dict(path: str) -> dict:
    import yaml
    with open(path) as f:
        return yaml.load(f.read(), yaml.FullLoader)


def num_classes_for_dataset(dataset: str) -> int:
    table = {"DanceTrack": 1, "SportsMOT": 1, "MOT17": 1, "MOT17_SPLIT": 1,
             "BDD100K": 8}
    if dataset not in table:
        raise ValueError(f"Unknown dataset '{dataset}'.")
    return table[dataset]
