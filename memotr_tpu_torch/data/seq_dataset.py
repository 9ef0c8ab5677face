"""Streaming-inference sequence dataset (counterpart of
``memotr_tpu/data/seq_dataset.py``, uint8 path).

Sorted frame list per sequence; each frame is decoded, resized to short
side ``image_height`` / long side at most ``image_width`` and placed on one
fixed canvas per sequence orientation (``padded_canvas``, which
``submit()`` groups sequences by), returned as raw uint8 with its pad mask
(ImageNet normalization runs on the device).  ``cv2`` is imported on
first use, so the rest of the port runs where it is not installed.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np


class SeqDataset:
    def __init__(self, seq_dir: str, image_height: int = 800,
                 image_width: int = 1536):
        img_dir = seq_dir if "BDD100K" in seq_dir else os.path.join(seq_dir, "img1")
        self.image_paths = [os.path.join(img_dir, n)
                            for n in sorted(os.listdir(img_dir))
                            if n.endswith((".jpg", ".png"))]
        self.image_height = image_height
        self.image_width = image_width
        # one fixed canvas per sequence orientation
        h, w = self.load(self.image_paths[0]).shape[:2]
        self.canvas = ((image_height, image_width) if h <= w
                       else (image_width, image_height))

    def __len__(self) -> int:
        return len(self.image_paths)

    def padded_canvas(self) -> Tuple[int, int]:
        """(H, W) of the canvas every frame of the sequence is placed on."""
        return self.canvas

    @staticmethod
    def load(path: str) -> np.ndarray:
        import cv2
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def __getitem__(self, item: int) -> Dict:
        import cv2
        path = self.image_paths[item]
        image = self.load(path)
        h, w = image.shape[:2]
        scale = self.image_height / min(h, w)
        if max(h, w) * scale > self.image_width:
            scale = self.image_width / max(h, w)
        th, tw = int(h * scale), int(w * scale)
        resized = cv2.resize(image, (tw, th))
        ch, cw = self.canvas
        canvas = np.zeros((ch, cw, 3), np.uint8)
        mask = np.ones((ch, cw), bool)
        canvas[:th, :tw] = resized
        mask[:th, :tw] = False
        return {"image": canvas, "mask": mask, "ori_hw": (h, w), "path": path}
