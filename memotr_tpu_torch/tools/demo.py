"""Video tracking demo: run the port on a video file and write an
annotated copy (counterpart of ``tools/demo.py``).

The streaming SeqDataset's resize onto a fixed canvas, the frame step
(``eval_frame_step``) with the runtime tracker, a colour per id, and the
annotated video out (XVID).  Runs on the GPU unless ``--device cpu``.

  python -m memotr_tpu_torch.tools.demo \
      --config configs/train_dancetrack.yaml \
      --checkpoint outputs/memotr_dancetrack/checkpoint_19.pth \
      --video in.mp4 --out out.avi

``--checkpoint`` is a port epoch checkpoint or a reference-format
``.pth`` (``{"model": state_dict}`` or a bare state dict).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch


def color_for_id(i: int):
    rng = np.random.default_rng(int(i) * 9781 + 3)
    return tuple(int(c) for c in rng.integers(64, 255, 3))


def canvas_frame(rgb: np.ndarray, short: int, long_max: int):
    """An RGB frame resized as the streaming dataset resizes it (short side
    to ``short``, the long side at most ``long_max``) onto the fixed
    canvas of its orientation -> (uint8 canvas (H, W, 3), mask (H, W) True
    = padding)."""
    import cv2
    oh, ow = rgb.shape[:2]
    canvas_hw = (short, long_max) if ow >= oh else (long_max, short)
    scale = short / min(oh, ow)
    if max(oh, ow) * scale > long_max:
        scale = long_max / max(oh, ow)
    th, tw = int(oh * scale), int(ow * scale)
    canvas = np.zeros((*canvas_hw, 3), np.uint8)
    mask = np.ones(canvas_hw, bool)
    canvas[:th, :tw] = cv2.resize(rgb, (tw, th))
    mask[:th, :tw] = False
    return canvas, mask


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser("demo")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--video", required=True)
    p.add_argument("--out", default="demo_out.avi")
    p.add_argument("--score-thresh", type=float, default=0.5)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import cv2

    from ..config import cfg_get, yaml_to_dict
    from ..engine.submit import (load_state_dict_file, normalize_uint8,
                                 resolve_device)
    from ..models.frame_step import eval_frame_step
    from ..models.memotr import build_model
    from ..structures.track_state import TrackState

    device = resolve_device(args.device)
    config = yaml_to_dict(args.config)
    model = build_model(config)
    model.load_state_dict(load_state_dict_file(args.checkpoint))
    model.to(device).eval()
    state = TrackState.empty(1, cfg_get(config, "TRACK_SLOTS"),
                             model.hidden_dim, model.num_classes,
                             use_dab=model.use_dab, device=device)
    short = cfg_get(config, "EVAL_SHORT_SIDE")
    long_max = cfg_get(config, "EVAL_MAX_SIDE")

    cap = cv2.VideoCapture(args.video)
    fps = cap.get(cv2.CAP_PROP_FPS) or 25
    ow = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    oh = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = cv2.VideoWriter(args.out, cv2.VideoWriter_fourcc(*"XVID"),
                             fps, (ow, oh))
    n = 0
    try:
        while True:
            ok, frame_bgr = cap.read()
            if not ok:
                break
            canvas, mask = canvas_frame(
                cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB), short, long_max)
            with torch.inference_mode():
                results, state = eval_frame_step(
                    model,
                    normalize_uint8(torch.from_numpy(canvas)[None].to(device)),
                    torch.from_numpy(mask)[None].to(device), state,
                    config["DET_SCORE_THRESH"], config["TRACK_SCORE_THRESH"],
                    config["MISS_TOLERANCE"])
                res = {k: results[k][0].cpu().numpy()
                       for k in ("mask", "scores", "boxes", "ids")}
            keep = res["mask"] & (res["scores"] > args.score_thresh)
            for j in np.nonzero(keep)[0]:
                cx, cy, w, h = res["boxes"][j]
                x1, y1 = int((cx - w / 2) * ow), int((cy - h / 2) * oh)
                x2, y2 = int((cx + w / 2) * ow), int((cy + h / 2) * oh)
                c = color_for_id(res["ids"][j])
                cv2.rectangle(frame_bgr, (x1, y1), (x2, y2), c, 2)
                cv2.putText(frame_bgr, str(int(res["ids"][j])),
                            (x1, max(y1 - 5, 10)), cv2.FONT_HERSHEY_SIMPLEX,
                            0.6, c, 2)
            writer.write(frame_bgr)
            n += 1
            if n % 50 == 0:
                print(f"{n} frames", flush=True)
    finally:
        cap.release()
        writer.release()
    print(f"wrote {args.out} ({n} frames)", flush=True)
    return n


if __name__ == "__main__":
    main()
