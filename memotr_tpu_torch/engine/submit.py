"""Streaming-inference submit engine, synchronous loop (counterpart of
``memotr_tpu/engine/submit.py``).

Per sequence: upload each uint8 frame, normalize it on the device, run the
frame step (forward -> lifecycle -> query updater), fetch the slot results,
filter by score and area, and append MOT txt lines (or collect BDD100K
JSON).  Unless ``EVAL_CACHE`` is false, the frame step reads its
mask-dependent constants from an ``EvalCache``, which rebuilds them for any
frame whose padding mask differs from the cached one.  The ``Submitter`` takes any iterable of frame dicts
``{"image": uint8 (H, W, 3), "mask": bool (H, W), "ori_hw", "path"}``, so it
runs without an image decoder; ``submit(config)`` feeds it ``SeqDataset``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, List

import numpy as np
import torch

from ..config import cfg_get, yaml_to_dict
from ..models.eval_cache import EvalCache
from ..models.frame_step import eval_frame_step
from ..models.memotr import build_model
from ..structures.track_state import TrackState

BDD_LABEL_NAMES = {
    0: "pedestrian", 1: "rider", 2: "car", 3: "truck", 4: "bus",
    5: "train", 6: "motorcycle", 7: "bicycle",
}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def results_to_pixels(results: Dict, ori_hw, result_thresh: float,
                      area_thresh: float = 100.0, lane: int = 0):
    """Host-numpy slot results -> (keep indices, x1, y1, w, h, ids, labels)
    in original pixels.  Boxes are normalized to the valid (unpadded)
    region, so they scale by the original frame size directly."""
    ori_h, ori_w = ori_hw
    keep = results["mask"][lane] & (results["scores"][lane] > result_thresh)
    boxes = results["boxes"][lane]
    cx = boxes[:, 0] * ori_w
    cy = boxes[:, 1] * ori_h
    w = boxes[:, 2] * ori_w
    h = boxes[:, 3] * ori_h
    keep = keep & (w * h > area_thresh)
    return (np.nonzero(keep)[0], cx - w / 2, cy - h / 2, w, h,
            results["ids"][lane], results["labels"][lane])


def format_frame_results(i: int, results: Dict, ori_hw, path: str,
                         result_thresh: float, area_thresh: float,
                         dataset_name: str, lane: int = 0):
    """One frame's host-numpy results -> ``(bdd_frame_dict, None)`` for
    BDD100K or ``(None, txt_lines)`` for MOT txt."""
    keep_idx, x1, y1, w, h, ids, labels = results_to_pixels(
        results, ori_hw, result_thresh, area_thresh, lane=lane)
    if dataset_name == "BDD100K":
        img_name = os.path.basename(path)
        frame_result = {
            "name": img_name, "videoName": img_name[:-12],
            "frameIndex": i, "labels": []}
        for j in keep_idx:
            frame_result["labels"].append({
                "id": str(int(ids[j])),
                "category": BDD_LABEL_NAMES[int(labels[j])],
                "box2d": {"x1": float(x1[j]), "y1": float(y1[j]),
                          "x2": float(x1[j] + w[j]),
                          "y2": float(y1[j] + h[j])}})
        return frame_result, None
    return None, [f"{i + 1},{int(ids[j])},{x1[j]},{y1[j]},"
                  f"{w[j]},{h[j]},1,-1,-1,-1\n" for j in keep_idx]


def normalize_uint8(images: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization of raw uint8 frames, on their device (uint8
    uploads are 4x smaller than float32)."""
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    return (images.float() / 255.0 - mean) / std


def resolve_device(device: torch.device | str) -> torch.device:
    """The device an entry point runs on: a CUDA device unless the caller
    asks for the CPU, and an error when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU; pass "
                           "device='cpu' to run on the CPU")
    return device


class Submitter:
    """Streams one sequence through the model and writes its results.

    ``frames`` is any iterable of frame dicts (see the module docstring).
    After ``run``, ``frame_seconds`` holds each frame's host wall time from
    upload to fetched results."""

    def __init__(self, dataset_name: str, frames: Iterable[Dict],
                 seq_name: str, outputs_dir: str, model, config: dict,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.dataset_name = dataset_name
        self.frames = frames
        self.seq_name = seq_name
        self.predict_dir = os.path.join(outputs_dir, "tracker")
        os.makedirs(self.predict_dir, exist_ok=True)
        self.model = model
        self.eval_cache = EvalCache(model, self.device) \
            if cfg_get(config, "EVAL_CACHE") else None
        self.det_thresh = config["DET_SCORE_THRESH"]
        self.track_thresh = config["TRACK_SCORE_THRESH"]
        self.result_thresh = config["RESULT_SCORE_THRESH"]
        self.miss_tolerance = config["MISS_TOLERANCE"]
        self.track_slots = cfg_get(config, "TRACK_SLOTS")
        self.area_thresh = 100
        self.frame_seconds: List[float] = []
        txt = os.path.join(self.predict_dir, f"{seq_name}.txt")
        if os.path.exists(txt):
            os.remove(txt)

    def _write_frame(self, i: int, results: Dict, ori_hw, path: str,
                     bdd_results: List[Dict]):
        bdd_frame, txt_lines = format_frame_results(
            i, results, ori_hw, path, self.result_thresh, self.area_thresh,
            self.dataset_name)
        if bdd_frame is not None:
            bdd_results.append(bdd_frame)
        else:
            with open(os.path.join(self.predict_dir,
                                   f"{self.seq_name}.txt"), "a") as f:
                f.write("".join(txt_lines))

    @torch.inference_mode()
    def run(self) -> float:
        """Returns the summed per-frame seconds (upload, step, fetch)."""
        m = self.model
        state = TrackState.empty(1, self.track_slots, m.hidden_dim,
                                 m.num_classes, use_dab=m.use_dab,
                                 device=self.device)
        bdd_results: List[Dict] = []
        overflow_total = 0
        self.frame_seconds = []
        for i, item in enumerate(self.frames):
            t0 = time.perf_counter()
            images = torch.from_numpy(np.ascontiguousarray(item["image"]))[None]
            mask = torch.from_numpy(np.ascontiguousarray(item["mask"]))[None]
            images = normalize_uint8(images.to(self.device))
            ctx = self.eval_cache.lookup(mask.numpy()) \
                if self.eval_cache is not None else None
            mask = mask.to(self.device)
            results, state = eval_frame_step(
                m, images, mask, state, self.det_thresh, self.track_thresh,
                self.miss_tolerance, ctx)
            results = {k: v.cpu().numpy() for k, v in results.items()}
            self.frame_seconds.append(time.perf_counter() - t0)
            overflow_total += int(results.pop("slot_overflow").sum())
            self._write_frame(i, results, item["ori_hw"], item["path"],
                              bdd_results)
        if self.dataset_name == "BDD100K":
            with open(os.path.join(self.predict_dir,
                                   f"{self.seq_name}.json"), "w") as f:
                json.dump(bdd_results, f)
        if overflow_total:
            print(f"[submit {self.seq_name}] WARNING: {overflow_total} "
                  f"newborn tracks dropped (all {self.track_slots} slots "
                  f"full) - raise TRACK_SLOTS", flush=True)
        return sum(self.frame_seconds)


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A reference-format checkpoint: ``{"model": state_dict}`` or a bare
    state dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt["model"] if "model" in ckpt else ckpt


def submit(config: dict, device: torch.device | str = "cuda"):
    """Submit entry: every sequence of the split, one ``Submitter`` each.

    Reads ``SUBMIT_DIR/train/config.yaml`` for the model and loads the
    reference-format ``.pth`` at ``SUBMIT_DIR/SUBMIT_MODEL``.  Runs on the
    GPU unless ``device="cpu"``."""
    from ..data.seq_dataset import SeqDataset
    device = resolve_device(device)
    train_config = yaml_to_dict(
        os.path.join(config["SUBMIT_DIR"], "train/config.yaml"))
    dataset_name = train_config["DATASET"]
    config = dict(config, DATASET=dataset_name)
    for key in ("HIDDEN_DIM", "TRACK_SLOTS", "USE_DAB"):
        if key in train_config:
            config.setdefault(key, train_config[key])

    model = build_model(train_config)
    model.load_state_dict(load_state_dict_file(
        os.path.join(config["SUBMIT_DIR"], config["SUBMIT_MODEL"])))
    model.to(device).eval()

    split = config["SUBMIT_DATA_SPLIT"]
    root = config["DATA_ROOT"]
    if dataset_name in ("DanceTrack", "SportsMOT"):
        split_dir = os.path.join(root, dataset_name, split)
    elif dataset_name == "BDD100K":
        split_dir = os.path.join(root, dataset_name, "images/track/", split)
    else:
        split_dir = os.path.join(root, dataset_name, "images", split)
    outputs_dir = os.path.join(config["SUBMIT_DIR"], split)
    for seq in sorted(os.listdir(split_dir)):
        print(f"Submitting {seq}", flush=True)
        ds = SeqDataset(os.path.join(split_dir, seq),
                        image_height=cfg_get(config, "EVAL_SHORT_SIDE"),
                        image_width=cfg_get(config, "EVAL_MAX_SIDE"))
        Submitter(dataset_name, (ds[i] for i in range(len(ds))), seq,
                  outputs_dir, model, config, device).run()
