"""The port's command line: train, submit or eval (counterpart of the root
``main.py``, which runs the JAX package).

    python -m memotr_tpu_torch.main --mode train --config-path configs/train_dancetrack.yaml \
        --data-root ./datasets/ --outputs-dir ./outputs/run/
    python -m memotr_tpu_torch.main --mode submit --config-path configs/train_dancetrack.yaml \
        --submit-dir ./outputs/run/ --submit-model checkpoint_19.pth --submit-data-split val
    python -m memotr_tpu_torch.main --mode eval --config-path configs/train_dancetrack.yaml \
        --data-root ./datasets/ --eval-dir ./outputs/run/ --eval-model checkpoint_19.pth

A YAML experiment file plus overlays: any provided ``--flag`` must name a
key of the file (or a default key, ``config.update_config``) and wins.
``--device`` (default ``cuda``) is the one flag the JAX CLI lacks: the way
to ask for the CPU.  ``--mode eval`` submits on ``EVAL_DATA_SPLIT`` and
scores (``engine/eval.py``; ``--eval-mode continue`` follows the epoch
checkpoints).  ``--multi-host`` runs one process a device under torchrun,
as JAX's flag starts ``jax.distributed``:

    torchrun --nproc_per_node 2 -m memotr_tpu_torch.main --multi-host \
        --mode train --config-path configs/train_dancetrack.yaml ...

Each process joins the group torchrun describes (NCCL on ``cuda``, gloo
with ``--device cpu``) on device ``cuda:LOCAL_RANK``; training shares the
batch and reduces the gradients (``engine/train.py``), submit and eval
shard the sequences (``engine/submit.py``, ``engine/eval.py``).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .config import update_config, yaml_to_dict

FLAGS = ["data-root", "outputs-dir", "seed", "batch-size", "epochs",
         "lr", "lr-backbone", "lr-points", "weight-decay",
         "resume", "pretrained-model", "use-checkpoint",
         "submit-dir", "submit-model", "submit-data-split",
         "eval-dir", "eval-mode", "eval-model", "eval-data-split",
         "eval-threads", "det-score-thresh", "track-score-thresh",
         "result-score-thresh", "miss-tolerance", "use-motion",
         "track-slots", "max-gts", "dtype", "msda-impl",
         "num-workers", "accumulation-steps", "dataset",
         "encoder-type", "window-size", "submit-batch",
         "mesh-devices", "mesh-seq-devices", "token-shard-axis",
         "distill-teacher", "warmup-iters", "visualize",
         "windowed-prenorm", "windowed-shared-cpb",
         "hybrid-deform-min-level", "pretrain-skip-encoder"]


def parse_option(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("MeMOTR (PyTorch)")
    p.add_argument("--config-path", type=str, required=True)
    p.add_argument("--mode", type=str, required=True,
                   choices=["train", "submit", "eval"])
    for flag in FLAGS:
        p.add_argument(f"--{flag}", type=str, default=None)
    p.add_argument("--multi-host", action="store_true",
                   help="one process a device under torchrun")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def _coerce(v):
    """A flag's string as int, float or bool where it reads as one."""
    if not isinstance(v, str):
        return v
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def config_from_args(args: argparse.Namespace) -> dict:
    options = {k: _coerce(v) for k, v in vars(args).items()
               if k not in ("config_path", "multi_host", "device")
               and v is not None}
    return update_config(yaml_to_dict(args.config_path), options)


def main(argv: Optional[Sequence[str]] = None):
    """Runs the mode; returns what ``train``, ``submit`` or ``evaluate``
    returns."""
    args = parse_option(argv)
    device = args.device
    if args.multi_host:
        import torch

        from .utils.distributed import init_from_env
        kind = torch.device(device).type
        _, _, local_rank = init_from_env(kind)
        if kind == "cuda":
            device = f"cuda:{local_rank}"
    config = config_from_args(args)
    if args.mode == "train":
        from .engine.train import train
        return train(config, device=device)
    if args.mode == "eval":
        from .engine.eval import evaluate
        return evaluate(config, device=device)
    from .engine.submit import submit
    return submit(config, device=device)


if __name__ == "__main__":
    main()
