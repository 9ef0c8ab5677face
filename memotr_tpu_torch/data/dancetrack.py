"""DanceTrack / SportsMOT clip dataset (counterpart of
``memotr_tpu/data/dancetrack.py``).

Both use the MOT-format ``gt/gt.txt`` per sequence (frame, id, x, y, w, h,
1, 1, 1); DanceTrack's frame files have 8 digits, SportsMOT's 6.
"""
from __future__ import annotations

import os

from ..config import cfg_get
from .mot import ClipDataset
from .transforms import transforms_for_eval, transforms_for_train


class DanceTrack(ClipDataset):
    def __init__(self, config: dict, split: str, transform):
        super().__init__(config, transform)
        self.dataset_name = config["DATASET"]
        self.split_dir = os.path.join(config["DATA_ROOT"], self.dataset_name,
                                      split)
        if not os.path.isdir(self.split_dir):
            raise FileNotFoundError(self.split_dir)
        for vid in sorted(os.listdir(self.split_dir)):
            gt_path = os.path.join(self.split_dir, vid, "gt", "gt.txt")
            if not os.path.isfile(gt_path):
                continue
            self.register_video(vid)
            with open(gt_path) as f:
                for line in f:
                    parts = line.strip().split(",")
                    t, obj = int(parts[0]), int(parts[1])
                    x, y, w, h = map(float, parts[2:6])
                    self.gts[vid].setdefault(t, []).append((obj, 0, x, y, w, h))
        self.set_epoch(0)

    def frame_path(self, vid: str, t: int) -> str:
        digits = 8 if self.dataset_name == "DanceTrack" else 6
        return os.path.join(self.split_dir, vid, "img1",
                            f"{t:0{digits}d}.jpg")


def build(config: dict, split: str) -> DanceTrack:
    if split == "train":
        transform = transforms_for_train(
            coco_size=cfg_get(config, "COCO_SIZE"),
            overflow_bbox=cfg_get(config, "OVERFLOW_BBOX"),
            reverse_clip=cfg_get(config, "REVERSE_CLIP"),
            sizes=cfg_get(config, "TRAIN_SHORT_SIDES"),
            max_size=cfg_get(config, "TRAIN_MAX_SIZE"))
    else:
        transform = transforms_for_eval()
    return DanceTrack(config=config, split=split, transform=transform)
