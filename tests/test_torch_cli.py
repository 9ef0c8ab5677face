"""The port's CLI overlay and logger against the JAX package's (no JAX
compile).

``update_config`` on every shipped ``configs/*.yaml`` with every flag of
the CLI (a value for each), an unknown key and an ambiguous key of a
nested config: the same resolved config, or the same exception;
``_coerce`` and the parsed flags of ``main``; the logger's files
(``log.txt``, a YAML dump, ``scalars.jsonl``) and metric averages byte for
byte; ``dict_to_yaml``.
"""
import glob
import os
import sys

import pytest

import main as jax_main
from memotr_tpu import config as jax_config
from memotr_tpu.log import logger as jax_logger
from memotr_tpu_torch import config as port_config
from memotr_tpu_torch import main as port_main
from memotr_tpu_torch.log import logger as port_logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
SAMPLES = ["3", "0.25", "1e-4", "true", "False", "configs/x.yaml", "xla",
           "-2", "None"]


def _outcome(update, config, options):
    try:
        return update(config, options)
    except (KeyError, ValueError) as e:
        return type(e).__name__


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_update_config_matches_jax(path):
    config = jax_config.yaml_to_dict(path)
    assert port_config.yaml_to_dict(path) == config
    option_sets = [{flag: SAMPLES[i % len(SAMPLES)]}
                   for i, flag in enumerate(port_main.FLAGS)]
    option_sets += [{"lr": 1e-3, "epochs": 2, "resume": None},
                    {"NOT_A_KEY": 1}, {"not-a-key": None},
                    {"mesh-devices": 1, "distill-teacher": "t"}]
    for options in option_sets:
        want = _outcome(jax_config.update_config, config, options)
        got = _outcome(port_config.update_config, config, options)
        assert got == want, options
    assert config == jax_config.yaml_to_dict(path)        # not modified


def test_nested_and_ambiguous_keys_match_jax():
    config = {"A": 1, "SUB": {"B": 2, "A2": {"C": 3}}, "DUP": {"C": 4},
              "LR": 0.1}
    for options in ({"b": 5}, {"c": 6}, {"a2": 7}, {"lr": "1e-3"},
                    {"TRACK_SLOTS": 8}, {"Z": 1}):
        want = _outcome(jax_config.update_config, config, options)
        got = _outcome(port_config.update_config, config, options)
        assert got == want, options
    assert _outcome(port_config.update_config, config, {"c": 6}) \
        == "ValueError"
    assert _outcome(port_config.update_config, config, {"Z": 1}) == "KeyError"


def test_coerce_and_parsed_flags_match_jax(monkeypatch):
    for v in SAMPLES + ["1.5e3", "TRUE", "", "0x10", 7, None]:
        assert port_main._coerce(v) == jax_main._coerce(v), v
    argv = ["--config-path", CONFIGS[0], "--mode", "train", "--lr", "1e-3",
            "--num-workers", "2", "--pretrain-skip-encoder", "false"]
    monkeypatch.setattr(sys, "argv", ["main.py"] + argv)
    want = vars(jax_main.parse_option())
    got = vars(port_main.parse_option(argv))
    assert got.pop("device") == "cuda"
    assert got == want
    assert vars(port_main.parse_option(argv + ["--device", "cpu"]))[
        "device"] == "cpu"
    options = {k: jax_main._coerce(v) for k, v in want.items()
               if k not in ("config_path", "multi_host") and v is not None}
    assert port_main.config_from_args(port_main.parse_option(argv)) == \
        jax_config.update_config(jax_config.yaml_to_dict(CONFIGS[0]), options)


def test_logger_files_match_jax(tmp_path):
    config = jax_config.yaml_to_dict(CONFIGS[0])
    logs = {}
    for name, mod, cfg_mod in (("jax", jax_logger, jax_config),
                               ("port", port_logger, port_config)):
        log = mod.Logger(str(tmp_path / name / "train"))
        assert os.path.isdir(log.logdir)
        cfg_mod.dict_to_yaml(config, os.path.join(log.logdir, "config.yaml"))
        log.write(config, filename="resolved.yaml")
        log.write("first line", head="[Epoch 0]")
        metrics = mod.MetricLog()
        for i in range(130):
            metrics.update("loss", 1.0 / (i + 1))
            metrics.update("time per iter", 0.5 + i % 3)
        metrics.sync()
        log.metric_log(metrics, step=129)
        log.scalars({"lr": 2e-4}, step=3, mode="epochs")
        logs[name] = (str(metrics), metrics.metrics["loss"].avg,
                      metrics.metrics["loss"].global_avg)
    assert logs["port"] == logs["jax"]
    for fn in ("config.yaml", "resolved.yaml", "log.txt", "scalars.jsonl"):
        with open(tmp_path / "jax" / "train" / fn) as f:
            want = f.read()
        with open(tmp_path / "port" / "train" / fn) as f:
            assert f.read() == want, fn
    assert port_config.yaml_to_dict(
        str(tmp_path / "port" / "train" / "config.yaml")) == config


# the keys the port's defaults once supplied that the JAX package's
# ``_DEFAULTS`` lacks: the command line may not add them to a config
PORT_ONLY_KEYS = (
    "AUX_LOSS", "AUX_LOSS_WEIGHT", "CLIP_MAX_NORM", "DROPOUT", "EPOCHS",
    "EVAL_CACHE", "LOSS_WEIGHT_FOCAL", "LOSS_WEIGHT_GIOU", "LOSS_WEIGHT_L1",
    "LR", "LR_BACKBONE", "LR_DROP_MILESTONES", "LR_DROP_RATE", "LR_POINTS",
    "LR_SCHEDULER", "MATCH_COST_BBOX", "MATCH_COST_CLASS", "MATCH_COST_GIOU",
    "MOTION_LAMBDA", "MULTI_CHECKPOINT", "NO_GRAD_STEPS", "TRAIN_MAX_SIZE",
    "TRAIN_SHORT_SIDES", "USE_CHECKPOINT", "WEIGHT_DECAY")


def test_defaults_are_jax_defaults():
    assert port_config._DEFAULTS == jax_config._DEFAULTS
    assert not set(port_config._READ_DEFAULTS) & set(port_config._DEFAULTS)


@pytest.mark.parametrize("key", PORT_ONLY_KEYS)
def test_absent_key_outside_jax_defaults_is_refused(key):
    config = {"DATASET": "DanceTrack"}
    for update in (jax_config.update_config, port_config.update_config):
        assert _outcome(update, config, {key.lower().replace("_", "-"): 1}) \
            == "KeyError"
    assert _outcome(port_config.update_config, config, {"lr": 1e-4}) \
        == _outcome(jax_config.update_config, config, {"lr": 1e-4}) \
        == "KeyError"


@pytest.mark.parametrize("key", ["WINDOW_SIZE", "SUBMIT_BATCH", "DTYPE"])
def test_absent_jax_default_key_overlays(key):
    config = {"DATASET": "DanceTrack"}
    want = jax_config.update_config(config, {key: 4})
    assert port_config.update_config(config, {key: 4}) == want \
        == {"DATASET": "DanceTrack", key: 4}


def test_read_defaults_are_what_jax_reads():
    """cfg_get falls back to the values the JAX package reads with
    ``config.get(key, default)``; the keys it reads without a default have
    none."""
    for key, value in port_config._READ_DEFAULTS.items():
        assert port_config.cfg_get({}, key) == value, key
    for key in port_config.TRAIN_REQUIRED + port_config.MULTISTEP_REQUIRED:
        if key != "DROPOUT":
            assert port_config.cfg_get({}, key) is None, key


@pytest.mark.parametrize("key", ["LR", "MATCH_COST_CLASS", "EPOCHS",
                                 "LR_DROP_MILESTONES"])
def test_train_raises_on_a_missing_required_key(tmp_path, key):
    from memotr_tpu_torch.engine.train import train
    config = port_config.yaml_to_dict(
        os.path.join(REPO, "configs", "train_dancetrack.yaml"))
    config.update(OUTPUTS_DIR=str(tmp_path / "out"),
                  DATA_ROOT=str(tmp_path / "data"))
    assert port_config.missing_train_keys(config) == []
    del config[key]
    with pytest.raises(KeyError, match=key):
        train(config, "cpu")
    assert not os.path.exists(tmp_path / "out")
    # the Cosine schedule reads no milestones
    if key == "LR_DROP_MILESTONES":
        assert port_config.missing_train_keys(
            dict(config, LR_SCHEDULER="Cosine")) == []
