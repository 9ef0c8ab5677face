"""Flat UPPER_CASE config: YAML experiment files, the CLI overlay and
defaults for the PyTorch port.

Same key space, defaults and overlay rules as ``memotr_tpu/config.py``: a
YAML file defines the (flat, UPPER_CASE) keys; ``update_config`` overlays
command-line options onto it, the CLI wins, and an option that names no
key of the file is an error unless it is one of the JAX package's
defaults (``_DEFAULTS``).  ``cfg_get`` also falls back to the values the
JAX package reads with a default (``_READ_DEFAULTS``); the keys its
training path reads without one are ``TRAIN_REQUIRED``.
``yaml`` is imported on first use only, so that the slices can be driven
from a dict built in code where PyYAML is not installed.
"""
from __future__ import annotations

import copy
from typing import Any

# Defaults for the keys an experiment YAML may omit: the JAX package's
# ``_DEFAULTS`` (memotr_tpu/config.py), key for key and value for value.
# ``update_config`` adds an absent key from the command line only if it is
# one of these, as the JAX package's does.  ``MSDA_IMPL`` is a TPU dispatch
# knob the port ignores: one CUDA kernel of each kind serves every shape on
# one device.  The mesh keys are TPU parallelism the port does not have
# (``engine/train.py`` raises unless they are unset or 1).
_DEFAULTS = {
    "MERGE_DET_TRACK_LAYER": 0,
    "TP_DROP_RATE": 0.0,
    "FP_INSERT_RATE": 0.0,
    "USE_MOTION": False,
    "MOTION_MIN_LENGTH": 3,
    "MOTION_MAX_LENGTH": 5,
    "EXTRA_TRACK_ATTN": False,
    "USE_DAB": True,
    "NUM_WORKERS": 4,
    "ACCUMULATION_STEPS": 1,
    "COCO_SIZE": False,
    "OVERFLOW_BBOX": False,
    "REVERSE_CLIP": 0.0,
    "NO_GRAD_FRAMES": None,
    "TRACK_SLOTS": 64,
    "MAX_GTS": 128,
    "DTYPE": "bfloat16",
    "EVAL_SHORT_SIDE": 800,
    "EVAL_MAX_SIDE": 1536,
    "MSDA_IMPL": "auto",
    "MESH_DEVICES": None,
    "TOKEN_SHARD_AXIS": None,
    "ENCODER_TYPE": "deformable",
    "WINDOWED_LEPE": True,
    "WINDOWED_BOTTOMUP": True,
    "WINDOWED_RELPOS": True,
    "WINDOW_SIZE": 8,
    "WINDOWED_PRENORM": False,
    "WINDOWED_SHARED_CPB": False,
    "HYBRID_DEFORM_MIN_LEVEL": 1,
    "WARMUP_ITERS": 0,
    "SUBMIT_BATCH": 1,
    "FIXED_TRAIN_CANVAS": None,   # (H, W): pad every train batch to one canvas
    "MESH_SEQ_DEVICES": 1,
    "DISTILL_TEACHER": None,      # an epoch checkpoint (.pth) of the port
    "DISTILL_WEIGHT_MEMORY": 1.0,
    "DISTILL_WEIGHT_LOGIT": 1.0,
    "DISTILL_WEIGHT_BOX": 1.0,
    "PRETRAIN_SKIP_ENCODER": None,  # None: skip iff ENCODER_TYPE != deformable
    "VISUALIZE": False,
}

# The values the JAX package reads with ``config.get(key, default)`` for
# keys outside ``_DEFAULTS``: ``cfg_get`` falls back to them, but the
# command line cannot add such a key to a config that lacks it.
_READ_DEFAULTS = {
    "AUX_LOSS": True,              # models/criterion.py
    "AUX_LOSS_WEIGHT": None,
    "CLIP_MAX_NORM": 0.1,          # engine/trainer.py
    "WEIGHT_DECAY": 0.0,
    "LR_SCHEDULER": "MultiStep",
    "DROPOUT": 0.0,
    "NO_GRAD_STEPS": None,
    "MULTI_CHECKPOINT": False,     # engine/train.py
    "USE_CHECKPOINT": False,       # models/memotr.py
    "TRAIN_SHORT_SIDES": None,     # data/dancetrack.py; None: MOTR_SCALES
    "TRAIN_MAX_SIZE": 1536,
    "EVAL_CACHE": True,            # engine/submit.py
    "MOTION_LAMBDA": 0.5,
}

# The keys the JAX package's training path (engine/train.py,
# engine/trainer.py, models/, data/) reads as ``config[key]``, on every
# run: ``engine/train.py: train`` raises when a config lacks one.
TRAIN_REQUIRED = (
    "DATASET", "DATA_ROOT", "OUTPUTS_DIR", "SEED", "BATCH_SIZE", "EPOCHS",
    "HIDDEN_DIM", "FFN_DIM", "NUM_FEATURE_LEVELS", "NUM_HEADS",
    "NUM_ENC_POINTS", "NUM_DEC_POINTS", "NUM_ENC_LAYERS", "NUM_DEC_LAYERS",
    "NUM_DET_QUERIES", "DROPOUT", "UPDATE_THRESH", "LONG_MEMORY_LAMBDA",
    "LR", "LR_BACKBONE", "LR_POINTS",
    "MATCH_COST_CLASS", "MATCH_COST_BBOX", "MATCH_COST_GIOU",
    "LOSS_WEIGHT_FOCAL", "LOSS_WEIGHT_L1", "LOSS_WEIGHT_GIOU",
    "SAMPLE_STEPS", "SAMPLE_LENGTHS", "SAMPLE_MODES", "SAMPLE_INTERVALS",
)
# ... and with the MultiStep LR schedule (the default)
MULTISTEP_REQUIRED = ("LR_DROP_MILESTONES", "LR_DROP_RATE")


def cfg_get(config: dict, key: str, default: Any = None) -> Any:
    if key in config and config[key] is not None:
        return config[key]
    if key in _DEFAULTS:
        return _DEFAULTS[key]
    if key in _READ_DEFAULTS:
        return _READ_DEFAULTS[key]
    return default


def missing_train_keys(config: dict) -> list:
    """The keys of ``TRAIN_REQUIRED`` (and, under the MultiStep schedule,
    ``MULTISTEP_REQUIRED``) that ``config`` lacks."""
    keys = TRAIN_REQUIRED
    if cfg_get(config, "LR_SCHEDULER") == "MultiStep":
        keys += MULTISTEP_REQUIRED
    return [k for k in keys if k not in config]


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
    ``KeyError`` unless it is a key of ``_DEFAULTS`` (the JAX package's
    list), which then overlays at the top level; a key found more than once in a nested config raises
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
