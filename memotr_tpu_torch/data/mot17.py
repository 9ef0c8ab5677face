"""MOT17 (+ CrowdHuman, + optional MOTSynth) clip dataset (counterpart of
``memotr_tpu/data/mot17.py``).

Mixes:

- MOT17 train sequences (the SDP detector's only), per-frame GT files
  ``gts/train/<seq>/img1/<t>.txt`` with lines ``_ id x y w h v``;
- CrowdHuman static images (``gts/val/<name>.txt``), repeated
  ``sample_length`` times as a clip and animated by ``MultiRandomShift``;
- optionally MOTSynth, subsampled each epoch by a generator of its own
  (seeded with ``SEED``);
- ``SAMPLE_MOT17_JOIN``: MOT17 clips join the pool from that epoch on.
"""
from __future__ import annotations

import os
import random

from .mot import ClipDataset, frame_info, interval_idxs, open_rgb
from .transforms import (GLOBAL_RNG, HostRNG, MOTR_SCALES, MultiCompose,
                         MultiHSV, MultiNormalize, MultiRandomCrop,
                         MultiRandomHorizontalFlip, MultiRandomResize,
                         MultiRandomSelect, MultiRandomShift,
                         MultiReverseClip)

CROWDHUMAN_ID_OFFSET = 100000


class MOT17(ClipDataset):
    def __init__(self, config: dict, split: str, transform):
        super().__init__(config, transform)
        if split != "train":
            raise ValueError(f"MOT17 split {split} unsupported")
        root = config["DATA_ROOT"]
        self.use_crowdhuman = bool(config.get("USE_CROWDHUMAN"))
        self.use_motsynth = bool(config.get("USE_MOTSYNTH"))
        self.motsynth_rate = config.get("MOTSYNTH_RATE") or 0.0
        self.sample_mot17_join = config.get("SAMPLE_MOT17_JOIN", 0)
        self.mot17_seqs_dir = os.path.join(root, config["DATASET"], "images",
                                           split)
        self.mot17_gts_dir = os.path.join(root, config["DATASET"], "gts", split)
        self.crowdhuman_seq_dir = os.path.join(root, "CrowdHuman", "images",
                                               "val")
        self.crowdhuman_gts_dir = os.path.join(root, "CrowdHuman", "gts", "val")
        self.motsynth_seqs_dir = os.path.join(root, "MOTSynth", "frames")
        self.motsynth_gts_dir = os.path.join(root, "MOTSynth", "gts")

        self.mot17_gts = {}
        if os.path.isdir(self.mot17_seqs_dir):
            for vid in sorted(os.listdir(self.mot17_seqs_dir)):
                if "SDP" not in vid:
                    continue
                gdir = os.path.join(self.mot17_gts_dir, vid, "img1")
                if not os.path.isdir(gdir):
                    continue
                self.mot17_gts[vid] = {}
                for fn in os.listdir(gdir):
                    rows = []
                    with open(os.path.join(gdir, fn)) as f:
                        for line in f:
                            _, i, x, y, w, h, v = line.strip("\n").split(" ")
                            rows.append((int(float(i)), 0, float(x), float(y),
                                         float(w), float(h)))
                    self.mot17_gts[vid][int(fn.split(".")[0])] = rows

        self.crowdhuman_gts = {}
        if self.use_crowdhuman and os.path.isdir(self.crowdhuman_gts_dir):
            for fn in sorted(os.listdir(self.crowdhuman_gts_dir)):
                rows = []
                with open(os.path.join(self.crowdhuman_gts_dir, fn)) as f:
                    for line in f:
                        _, i, x, y, w, h = line.strip("\n").split(" ")
                        rows.append((int(i) + CROWDHUMAN_ID_OFFSET, 0,
                                     float(x), float(y), float(w), float(h)))
                self.crowdhuman_gts[fn.split(".")[0]] = rows

        self.motsynth_gts = {}
        if self.use_motsynth and os.path.isdir(self.motsynth_gts_dir):
            for vid in sorted(os.listdir(self.motsynth_seqs_dir)):
                gt_path = os.path.join(self.motsynth_gts_dir, vid, "gt",
                                       "gt.txt")
                if not os.path.isfile(gt_path):
                    continue
                self.motsynth_gts[vid] = {}
                with open(gt_path) as f:
                    for line in f:
                        parts = line.strip().split(",")
                        t, i = int(parts[0]), int(parts[1])
                        x, y, w, h = map(float, parts[2:6])
                        a, b_, c = int(parts[6]), int(parts[7]), float(parts[8])
                        if a == 0 or b_ != 1 or c == 0:
                            continue
                        self.motsynth_gts[vid].setdefault(t, []).append(
                            (i, 0, x, y, w, h))
            self._motsynth_rng = random.Random(config["SEED"])

        self.set_epoch(0)

    def set_epoch(self, epoch: int):
        """Items are ``(kind, vid or image name, begin frame)``."""
        self.set_stage(epoch)
        if self.use_crowdhuman:
            for name in self.crowdhuman_gts:
                self.sample_begin_frames.append(("crowdhuman", name, 0))
        if epoch >= self.sample_mot17_join:
            for vid, frames in self.mot17_gts.items():
                t_min, t_max = min(frames), max(frames)
                self.sample_vid_tmax[vid] = t_max
                for t in range(t_min, t_max - (self.sample_length - 1) + 1):
                    self.sample_begin_frames.append(("mot17", vid, t))
        if self.use_motsynth:
            for vid, frames in self.motsynth_gts.items():
                t_min, t_max = min(frames), max(frames)
                self.sample_vid_tmax[vid] = t_max
                for t in range(t_min, t_max - (self.sample_length - 1) + 1):
                    if self._motsynth_rng.random() > self.motsynth_rate:
                        continue
                    self.sample_begin_frames.append(("motsynth", vid, t))

    def _frame(self, kind: str, vid: str, t: int):
        if kind == "crowdhuman":
            path = os.path.join(self.crowdhuman_seq_dir, f"{vid}.jpg")
            rows = self.crowdhuman_gts[vid]
        elif kind == "motsynth":
            path = os.path.join(self.motsynth_seqs_dir, vid, "rgb",
                                f"{t:04d}.jpg")
            rows = self.motsynth_gts[vid].get(t, [])
        else:
            path = os.path.join(self.mot17_seqs_dir, vid, "img1",
                                f"{t:06d}.jpg")
            rows = self.mot17_gts[vid].get(t, [])
        info = frame_info(rows)
        info["dataset"] = "CrowdHuman" if kind == "crowdhuman" else "MOT17"
        return open_rgb(path), info

    def get(self, item: int, rng: HostRNG = GLOBAL_RNG):
        kind, vid, begin = self.sample_begin_frames[item]
        if kind == "crowdhuman":
            idxs = [0] * self.sample_length
        else:
            idxs = interval_idxs(rng, begin, self.sample_vid_tmax[vid],
                                 self.sample_length, self.sample_interval)
        imgs, infos = zip(*[self._frame(kind, vid, t) for t in idxs])
        imgs, infos = list(imgs), list(infos)
        key = "CrowdHuman" if kind == "crowdhuman" else "MOT17"
        if self.transform is not None:
            imgs, infos = self.transform[key](imgs, infos, rng)
        return {"imgs": list(imgs), "infos": list(infos)}


def transforms_for_train(coco_size=False, overflow_bbox=False,
                         reverse_clip=0.0):
    """One stack per source; CrowdHuman's adds ``MultiRandomShift``."""
    def stack(with_shift: bool):
        steps = [MultiRandomHorizontalFlip()]
        if with_shift:
            steps.append(MultiRandomShift())
        steps += [
            MultiRandomSelect(
                MultiRandomResize(MOTR_SCALES, max_size=1536),
                MultiCompose([
                    MultiRandomResize([400, 500, 600] if coco_size
                                      else [800, 1000, 1200]),
                    MultiRandomCrop(min_size=384 if coco_size else 800,
                                    max_size=600 if coco_size else 1200,
                                    overflow_bbox=overflow_bbox),
                    MultiRandomResize(MOTR_SCALES, max_size=1536),
                ])),
            MultiHSV(),
            MultiNormalize(),
            MultiReverseClip(reverse=reverse_clip),
        ]
        return MultiCompose(steps)

    return {"MOT17": stack(False), "CrowdHuman": stack(True)}


def build(config: dict, split: str) -> MOT17:
    return MOT17(config=config, split=split,
                 transform=transforms_for_train(
                     coco_size=config.get("COCO_SIZE", False),
                     overflow_bbox=config.get("OVERFLOW_BBOX", False),
                     reverse_clip=config.get("REVERSE_CLIP", 0.0)))
