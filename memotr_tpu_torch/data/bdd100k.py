"""BDD100K multi-class (8) tracking dataset (counterpart of
``memotr_tpu/data/bdd100k.py``).

Per-frame GT files ``filter_labels/track/train/<vid>/<vid>-<t:07d>.txt``
with lines ``class id x y w h`` (classes 1-based, labels 0-based).  As in
the reference: clips whose sampled frames lack GT fall back to
consecutive frames, begin frames whose consecutive window lacks GT are
left out, a frame without objects gets one fake GT, and the resize scales
are COCO's with max size 1333 and overflow-tolerant crops.
"""
from __future__ import annotations

import os

from .mot import ClipDataset, frame_info, open_rgb
from .transforms import (GLOBAL_RNG, HostRNG, MultiCompose, MultiHSV,
                         MultiNormalize, MultiRandomCrop,
                         MultiRandomHorizontalFlip, MultiRandomResize,
                         MultiRandomSelect)
from .transforms import transforms_for_train as shared_train_transforms

CATEGORY_TO_LABEL = {
    "pedestrian": 0, "rider": 1, "car": 2, "truck": 3, "bus": 4,
    "train": 5, "motorcycle": 6, "bicycle": 7,
    "other vehicle": 2, "other person": 0, "trailer": 3,
}
LABEL_TO_CATEGORY = {
    0: "pedestrian", 1: "rider", 2: "car", 3: "truck", 4: "bus",
    5: "train", 6: "motorcycle", 7: "bicycle",
}
BDD_SCALES = [480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800]


class BDD100K(ClipDataset):
    def __init__(self, config: dict, split: str, transform):
        super().__init__(config, transform)
        if split != "train":
            raise ValueError(f"BDD100K split {split} unsupported")
        root = config["DATA_ROOT"]
        self.images_dir = os.path.join(root, "BDD100K", "images/track/train/")
        self.gts_dir = os.path.join(root, "BDD100K",
                                    "filter_labels/track/train/")
        if not os.path.isdir(self.images_dir):
            raise FileNotFoundError(self.images_dir)
        for vid in sorted(os.listdir(self.images_dir)):
            self.register_video(vid)
            for fn in sorted(os.listdir(os.path.join(self.images_dir, vid))):
                gt_name = fn.replace(".jpg", ".txt")
                gt_path = os.path.join(self.gts_dir, vid, gt_name)
                if not os.path.exists(gt_path):
                    continue
                rows = []
                with open(gt_path) as f:
                    for line in f:
                        c, i, *xywh = line.rstrip("\n").split(" ")
                        x, y, w, h = map(float, xywh)
                        rows.append((int(i), int(c) - 1, x, y, w, h))
                self.gts[vid][int(gt_name[:-4].split("-")[-1])] = rows
        self.set_epoch(0)

    def set_epoch(self, epoch: int):
        super().set_epoch(epoch)
        self.sample_begin_frames = [
            (vid, t) for vid, t in self.sample_begin_frames
            if all((t + k) in self.gts[vid] for k in range(self.sample_length))]

    def sample_frame_idxs(self, vid: str, begin: int,
                          rng: HostRNG = GLOBAL_RNG):
        idxs = super().sample_frame_idxs(vid, begin, rng)
        if any(t not in self.gts[vid] for t in idxs):
            idxs = [begin + k for k in range(self.sample_length)]
        return idxs

    def frame_path(self, vid: str, t: int) -> str:
        return os.path.join(self.images_dir, vid, f"{vid}-{t:07d}.jpg")

    def load_frame(self, vid: str, t: int):
        # a frame without objects gets one fake GT, as in the reference
        info = frame_info(self.gts[vid].get(t) or [(0, 0, 0.5, 0.5, 0.5, 0.5)])
        info["frame_idx"] = t
        return open_rgb(self.frame_path(vid, t)), info


def transforms_for_train():
    return MultiCompose([
        MultiRandomHorizontalFlip(),
        MultiRandomSelect(
            MultiRandomResize(sizes=BDD_SCALES, max_size=1333),
            MultiCompose([
                MultiRandomResize([400, 500, 600]),
                MultiRandomCrop(min_size=384, max_size=600, overflow_bbox=True),
                MultiRandomResize(sizes=BDD_SCALES, max_size=1333),
            ])),
        MultiHSV(),
        MultiNormalize(),
    ])


def build(config: dict, split: str) -> BDD100K:
    if config.get("TRAIN_SHORT_SIDES"):
        tf = shared_train_transforms(
            sizes=config["TRAIN_SHORT_SIDES"],
            max_size=config.get("TRAIN_MAX_SIZE", 1333))
    else:
        tf = transforms_for_train()
    return BDD100K(config=config, split=split, transform=tf)
