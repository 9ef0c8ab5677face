"""Flat UPPER_CASE config: YAML experiment files, the CLI overlay and
defaults for the PyTorch port.

Same key space, defaults and overlay rules as ``memotr_tpu/config.py``: a
YAML file defines the (flat, UPPER_CASE) keys; ``update_config`` overlays
command-line options onto it, the CLI wins, and an option that names no
key of the file is an error unless it is one of the defaults below.
``yaml`` is imported on first use only, so that the slices can be driven
from a dict built in code where PyYAML is not installed.
"""
from __future__ import annotations

import copy
from typing import Any

# Defaults for keys an experiment YAML may omit (memotr_tpu/config.py).
# ``MSDA_IMPL`` is a TPU dispatch knob the port ignores: one CUDA kernel of
# each kind serves every shape on one device.  The mesh keys are TPU
# parallelism the port does not have (``engine/train.py`` raises unless they
# are unset or 1).  The training keys default as the JAX trainer reads
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
    # data and the training loop
    "NUM_WORKERS": 4,
    "COCO_SIZE": False,
    "OVERFLOW_BBOX": False,
    "REVERSE_CLIP": 0.0,
    "FIXED_TRAIN_CANVAS": None,   # (H, W): pad every train batch to one canvas
    "TRAIN_SHORT_SIDES": None,    # replaces MOTR_SCALES (no resize-crop branch)
    "TRAIN_MAX_SIZE": 1536,
    "MULTI_CHECKPOINT": False,
    "PRETRAIN_SKIP_ENCODER": None,  # None: skip iff ENCODER_TYPE != deformable
    "DISTILL_TEACHER": None,      # an epoch checkpoint (.pth) of the port
    "DISTILL_WEIGHT_MEMORY": 1.0,
    "DISTILL_WEIGHT_LOGIT": 1.0,
    "DISTILL_WEIGHT_BOX": 1.0,
    # TPU knobs, accepted on the command line as JAX's CLI accepts them
    "MSDA_IMPL": "auto",
    "MESH_DEVICES": None,
    "MESH_SEQ_DEVICES": 1,
    "TOKEN_SHARD_AXIS": None,
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


def dict_to_yaml(config: dict, path: str) -> None:
    """Writes a resolved config (``submit()`` reads it back)."""
    import yaml
    with open(path, "w") as f:
        yaml.dump(config, f, allow_unicode=True, sort_keys=False)


def _key_occurrences(config: Any, key: str) -> int:
    """How many times ``key`` appears anywhere in a (nested) config."""
    count = 0
    if isinstance(config, dict):
        for k, v in config.items():
            count += (k == key) + _key_occurrences(v, key)
    return count


def _overlay(config: dict, key: str, value: Any) -> None:
    """Sets ``key = value`` wherever ``key`` is, at any depth."""
    for k in list(config):
        if k == key:
            config[k] = value
        elif isinstance(config[k], dict):
            _overlay(config[k], key, value)


def update_config(config: dict, options: dict) -> dict:
    """Overlays command-line ``options`` onto a YAML ``config`` (a copy);
    the CLI wins.  Options whose value is ``None`` are skipped.  A key (in
    ``--kebab-case`` or UPPER_CASE) that the config lacks raises
    ``KeyError`` unless it is a default key, which then overlays at the top
    level; a key found more than once in a nested config raises
    ``ValueError``."""
    config = copy.deepcopy(config)
    for key, value in options.items():
        if value is None:
            continue
        key = key.upper().replace("-", "_")
        n = _key_occurrences(config, key)
        if n == 0 and key in _DEFAULTS:
            config[key] = value
        elif n == 0:
            raise KeyError(f"CLI option '{key}' does not match any config key.")
        elif n > 1:
            raise ValueError(f"CLI option '{key}' is ambiguous ({n} matches).")
        else:
            _overlay(config, key, value)
    return config


def num_classes_for_dataset(dataset: str) -> int:
    table = {"DanceTrack": 1, "SportsMOT": 1, "MOT17": 1, "MOT17_SPLIT": 1,
             "BDD100K": 8}
    if dataset not in table:
        raise ValueError(f"Unknown dataset '{dataset}'.")
    return table[dataset]
