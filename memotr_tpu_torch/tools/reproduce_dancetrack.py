"""One-command reproduction of the reference's DanceTrack benchmark with
the port (counterpart of ``tools/reproduce_dancetrack.py``).

For a user who has a released reference ``.pth`` and the dataset:

    python -m memotr_tpu_torch.tools.reproduce_dancetrack \
        --checkpoint ./memotr_dancetrack.pth \
        --data-root  /path/to/DATADIR \
        --out        /tmp/repro_dancetrack \
        --split      val --expected-hota <paper val HOTA>

which, in one process,

1. writes ``<out>/train/config.yaml`` (the architecture config, by
   default ``configs/train_dancetrack.yaml``, the released checkpoints'
   shape) and links the ``.pth`` into ``<out>``;
2. **submits** every sequence of ``--split`` through the port's streaming
   engine, which loads the ``.pth`` (``{"model": state_dict}`` or a bare
   state dict) strictly: a missing or unexpected key is an error;
3. **scores** it with the port's metrics (``memotr_tpu_torch/metrics``),
   printing one JSON line with HOTA, DetA, AssA, MOTA and IDF1.

With ``--expected-hota`` the exit code says whether |HOTA - expected| <=
``--tolerance``.  The DanceTrack test split has no public GT: ``--split
test`` writes the tracker txts only.  ``USE_DAB`` defaults to True here as
in the port's ``build_model`` and config (``config.py``), so a config
without the key reads a released DAB checkpoint.  Runs on the GPU unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

PUBLISHED_TEST = {"HOTA": 68.5, "DetA": 80.5, "AssA": 58.4}  # README test set
SUMMARY = ("HOTA", "DetA", "AssA", "MOTA", "IDF1")
DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "..", "..", "configs", "train_dancetrack.yaml")


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="released MeMOTR .pth -> submit -> HOTA (PyTorch port)")
    p.add_argument("--checkpoint", required=True,
                   help=".pth of the reference's format")
    p.add_argument("--data-root", required=True,
                   help="DATADIR containing DanceTrack/")
    p.add_argument("--out", required=True, help="working/output directory")
    p.add_argument("--config", default=DEFAULT_CONFIG,
                   help="architecture config (default: the released-"
                        "checkpoint shape)")
    p.add_argument("--split", default="val",
                   help="val (scored locally) or test (txts only, no GT)")
    p.add_argument("--expected-hota", type=float, default=None,
                   help="exit 1 unless |HOTA - expected| <= tolerance")
    p.add_argument("--tolerance", type=float, default=0.5)
    p.add_argument("--submit-batch", type=int, default=None,
                   help="stream N sequences per step (SUBMIT_BATCH)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..config import cfg_get, dict_to_yaml, yaml_to_dict
    from ..engine.eval import eval_model
    from ..engine.submit import resolve_device, submit
    from ..log.logger import Logger

    device = resolve_device(args.device)
    if not (os.path.isfile(args.checkpoint)
            and args.checkpoint.endswith((".pth", ".pt", ".bin"))):
        raise SystemExit(f"--checkpoint {args.checkpoint}: not a .pth file")
    cfg = yaml_to_dict(args.config)
    cfg.update(DATA_ROOT=args.data_root, EVAL_DATA_SPLIT=args.split,
               OUTPUTS_DIR=args.out, USE_DAB=cfg_get(cfg, "USE_DAB"))
    if args.submit_batch:
        cfg["SUBMIT_BATCH"] = args.submit_batch
    # submit reads the run's config from <out>/train/config.yaml and the
    # model from <out>/<name>
    os.makedirs(os.path.join(args.out, "train"), exist_ok=True)
    dict_to_yaml(cfg, os.path.join(args.out, "train/config.yaml"))
    model_name = os.path.basename(args.checkpoint)
    target = os.path.join(args.out, model_name)
    if os.path.abspath(target) != os.path.abspath(args.checkpoint):
        if os.path.lexists(target):
            os.remove(target)
        os.symlink(os.path.abspath(args.checkpoint), target)

    if args.split == "test":
        submit(dict(cfg, SUBMIT_DIR=args.out, SUBMIT_MODEL=model_name,
                    SUBMIT_DATA_SPLIT="test"), device)
        print(json.dumps({"split": "test", "tracker_dir":
                          os.path.join(args.out, "test/tracker"),
                          "published_test": PUBLISHED_TEST,
                          "note": "no local GT; submit txts to the "
                                  "DanceTrack server"}), flush=True)
        return 0

    cfg["EVAL_DIR"] = args.out
    logger = Logger(logdir=os.path.join(args.out, args.split))
    metrics = eval_model(cfg, args.out, model_name, logger, device)
    result = {k: round(float(metrics[k]), 3) for k in SUMMARY
              if k in metrics}
    result["split"] = args.split
    result["published_test"] = PUBLISHED_TEST
    if args.expected_hota is not None:
        delta = float(metrics["HOTA"]) - args.expected_hota
        result["expected_hota"] = args.expected_hota
        result["delta"] = round(delta, 3)
        result["pass"] = abs(delta) <= args.tolerance
    print(json.dumps(result), flush=True)
    return 0 if result.get("pass", True) else 1


if __name__ == "__main__":
    raise SystemExit(main())
