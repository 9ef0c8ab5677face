"""Flat UPPER_CASE config access for the PyTorch port.

Same key space and defaults as ``memotr_tpu/config.py`` for the keys the
streaming-inference and training slices read.  ``yaml`` is imported only
inside ``yaml_to_dict``: the machine that runs the port on the GPU has no
PyYAML, and the slices can be driven from a dict built in code.
"""
from __future__ import annotations

from typing import Any

# Defaults for keys an experiment YAML may omit (memotr_tpu/config.py).
# ``MSDA_IMPL``, ``WINDOWED_ATTN_IMPL`` and ``TOKEN_SHARD_AXIS`` are TPU
# dispatch knobs the port ignores: one CUDA kernel of each kind serves every
# shape on one device.  The training keys default as the JAX trainer reads
# them (``config.get(key, default)`` there); the keys it requires default to
# ``configs/train_dancetrack.yaml``'s values.
_DEFAULTS = {
    # training: optimizer and schedule
    "LR": 2.0e-4,
    "LR_BACKBONE": 2.0e-5,
    "LR_POINTS": 1.0e-5,
    "WEIGHT_DECAY": 0.0,
    "CLIP_MAX_NORM": 0.1,
    "LR_SCHEDULER": "MultiStep",
    "LR_DROP_RATE": 0.1,
    "LR_DROP_MILESTONES": [12],
    "EPOCHS": 20,
    "WARMUP_ITERS": 0,
    "ACCUMULATION_STEPS": 1,
    "NO_GRAD_FRAMES": None,
    "NO_GRAD_STEPS": None,
    # training: matching, losses, track augmentation
    "MATCH_COST_CLASS": 2.0,
    "MATCH_COST_BBOX": 5.0,
    "MATCH_COST_GIOU": 2.0,
    "LOSS_WEIGHT_FOCAL": 2.0,
    "LOSS_WEIGHT_L1": 5.0,
    "LOSS_WEIGHT_GIOU": 2.0,
    "AUX_LOSS": True,
    "AUX_LOSS_WEIGHT": None,
    "TP_DROP_RATE": 0.0,
    "FP_INSERT_RATE": 0.0,
    "MAX_GTS": 128,
    "DROPOUT": 0.0,
    "USE_CHECKPOINT": False,
    # model and streaming
    "MERGE_DET_TRACK_LAYER": 0,
    "EXTRA_TRACK_ATTN": False,
    "USE_DAB": True,
    "TRACK_SLOTS": 64,
    "DTYPE": "bfloat16",
    "EVAL_SHORT_SIDE": 800,
    "EVAL_MAX_SIDE": 1536,
    "ENCODER_TYPE": "deformable",
    "WINDOW_SIZE": 8,
    "WINDOWED_LEPE": True,
    "WINDOWED_BOTTOMUP": True,
    "WINDOWED_RELPOS": True,
    "WINDOWED_PRENORM": False,
    "WINDOWED_SHARED_CPB": False,
    "HYBRID_DEFORM_MIN_LEVEL": 1,
    "EVAL_CACHE": True,
    # streaming: the batched loop's lanes, post-hoc motion, debug dumps
    "SUBMIT_BATCH": 1,
    "USE_MOTION": False,
    "MOTION_LAMBDA": 0.5,
    "MOTION_MIN_LENGTH": 3,
    "MOTION_MAX_LENGTH": 5,
    "VISUALIZE": False,
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
