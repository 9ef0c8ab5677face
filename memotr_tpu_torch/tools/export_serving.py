"""Export a trained port checkpoint as a self-contained serving artifact
(counterpart of ``tools/export_serving.py``).

Traces the streaming tracking step with ``torch.export`` (the weights
inside the program) and writes it beside the fresh track state and a
manifest, so that a serving host needs only torch, numpy and the op
registration module (``memotr_tpu_torch/serving.py`` has the layout).

  python -m memotr_tpu_torch.tools.export_serving --submit-dir outputs/run \
      --submit-model checkpoint_19 --out artifact/ [--height 800 \
      --width 1536] [--batch 1] [--device cuda]

``--submit-dir`` is a training run's outputs directory (it holds
``train/config.yaml``), ``--submit-model`` one of its epoch checkpoints
(``checkpoint_<e>.pth``; the suffix may be left out).  The export runs on
the GPU unless ``--device cpu`` is given, and the artifact serves on the
device it was exported on.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def checkpoint_path(submit_dir: str, submit_model: str) -> str:
    path = os.path.join(submit_dir, submit_model)
    if not os.path.exists(path) and os.path.exists(path + ".pth"):
        path += ".pth"
    return path


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser("export_serving")
    p.add_argument("--submit-dir", required=True,
                   help="training outputs dir (contains train/config.yaml)")
    p.add_argument("--submit-model", required=True,
                   help="epoch checkpoint, e.g. checkpoint_19(.pth)")
    p.add_argument("--out", required=True)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..config import yaml_to_dict
    from ..engine.submit import load_state_dict_file
    from ..serving import export_streaming

    config = yaml_to_dict(os.path.join(args.submit_dir, "train/config.yaml"))
    state_dict = load_state_dict_file(checkpoint_path(args.submit_dir,
                                                      args.submit_model))
    canvas = (args.height, args.width) if args.height and args.width \
        else None
    out = export_streaming(config, state_dict, args.out, canvas_hw=canvas,
                           batch=args.batch, device=args.device)
    print(f"exported serving artifact -> {out}", flush=True)
    return out


if __name__ == "__main__":
    main()
