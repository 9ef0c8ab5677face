"""One-off GT converters: MOT17 / CrowdHuman / BDD100K -> per-frame txt
files (counterpart of ``memotr_tpu/data/gen_gts.py``).

One CLI taking paths as arguments.  Output formats match what the datasets
expect:

- MOT17/CrowdHuman: ``gts/<split>/<seq>/img1/<frame>.txt`` lines
  ``0 <tid> <x> <y> <w> <h> <vis>`` (gen_mot17_gts.py:44-47) — only
  considered (mark != 0), pedestrian-class rows, with globally re-numbered
  track ids.
- BDD100K: ``filter_labels/track/<split>/<vid>/<name>.txt`` lines
  ``<class> <id> <x> <y> <w> <h>`` using the 8-class map (bdd100k.py:21-46).

Usage:
  python -m memotr_tpu_torch.data.gen_gts mot17 --seq-root .../images/train --out .../gts/train
  python -m memotr_tpu_torch.data.gen_gts crowdhuman --data-root .../images/val \
      --ann .../annotation_val.odgt --out .../gts/val
  python -m memotr_tpu_torch.data.gen_gts bdd100k --ann-dir .../labels/box_track_20/train \
      --out .../filter_labels/track/train
"""
from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

from .bdd100k import CATEGORY_TO_LABEL, LABEL_TO_CATEGORY


def gen_mot17(seq_root: str, out_root: str):
    tid_curr, tid_last = 0, -1
    for seq in sorted(os.listdir(seq_root)):
        gt_txt = os.path.join(seq_root, seq, "gt", "gt.txt")
        if not os.path.isfile(gt_txt):
            continue
        out_dir = os.path.join(out_root, seq, "img1")
        os.makedirs(out_dir, exist_ok=True)
        per_frame = defaultdict(list)
        with open(gt_txt) as f:
            for line in f:
                p = line.strip().split(",")
                fid, tid = int(float(p[0])), int(float(p[1]))
                x, y, w, h = (float(v) for v in p[2:6])
                mark, label, vis = float(p[6]), float(p[7]), float(p[8])
                if mark == 0 or label != 1:
                    continue
                if tid != tid_last:
                    tid_curr += 1
                    tid_last = tid
                per_frame[fid].append(
                    f"0 {tid_curr:d} {int(x):d} {int(y):d} {int(w):d} "
                    f"{int(h):d} {vis:f}\n")
        for fid, rows in per_frame.items():
            with open(os.path.join(out_dir, f"{fid:06d}.txt"), "w") as f:
                f.writelines(rows)
    print(f"MOT17 gts written to {out_root}")


def gen_crowdhuman(data_root: str, ann_path: str, out_root: str):
    os.makedirs(out_root, exist_ok=True)
    tid_curr = 0
    with open(ann_path) as f:
        records = [json.loads(line) for line in f]
    for rec in records:
        name = rec["ID"]
        # The reference (gen_crowdhuman_gts.py:34-40) cv2.imread()s every
        # annotated image, crashing on a missing file; validate the same
        # invariant explicitly.
        img_path = os.path.join(data_root, f"{name}.jpg")
        if not os.path.isfile(img_path):
            raise FileNotFoundError(
                f"annotated image missing from data root: {img_path}")
        rows = []
        for box in rec.get("gtboxes", []):
            if box.get("tag") != "person":
                continue
            extra = box.get("extra", {})
            if extra.get("ignore", 0) == 1:
                continue
            x, y, w, h = box["fbox"]
            tid_curr += 1
            rows.append(f"0 {tid_curr:d} {int(x):d} {int(y):d} "
                        f"{int(w):d} {int(h):d}\n")
        with open(os.path.join(out_root, f"{name}.txt"), "w") as f:
            f.writelines(rows)
    print(f"CrowdHuman gts written to {out_root}")


def gen_bdd100k(ann_dir: str, out_root: str):
    # The reference's executed path (gen_bdd100k_gts.py:121, filter_crowd=True
    # filter_ignore=True) keeps only the 8 canonical category names
    # (attr_id_dict, gen_bdd100k_gts.py:23-25) — the 'other person' /
    # 'other vehicle' / 'trailer' aliases in CATEGORY_TO_LABEL exist for
    # *reading* foreign GT files, not for generating them.
    canonical = set(LABEL_TO_CATEGORY.values())
    for fn in sorted(os.listdir(ann_dir)):
        if not fn.endswith(".json"):
            continue
        vid = fn[:-5]
        out_dir = os.path.join(out_root, vid)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(ann_dir, fn)) as f:
            frames = json.load(f)
        for frame in frames:
            labels = frame.get("labels", [])
            if len(labels) < 1:
                # Reference skips the frame before opening the file
                # (gen_bdd100k_gts.py:42-43) — downstream bdd100k.py then
                # treats it as GT-missing.  A frame whose labels were ALL
                # crowd/ignore-filtered still gets an (empty) file.
                continue
            rows = []
            for label in labels:
                cat = label.get("category")
                if cat not in canonical:
                    continue
                attrs = label.get("attributes", {})
                if attrs.get("crowd", False):
                    continue
                b = label["box2d"]
                x, y = b["x1"], b["y1"]
                w, h = b["x2"] - b["x1"], b["y2"] - b["y1"]
                rows.append(f"{CATEGORY_TO_LABEL[cat] + 1} "
                            f"{int(label['id'])} {x} {y} {w} {h}\n")
            with open(os.path.join(out_dir,
                                   frame["name"].replace(".jpg", ".txt")),
                      "w") as f:
                f.writelines(rows)
    print(f"BDD100K filter_labels written to {out_root}")


def main(argv=None):
    p = argparse.ArgumentParser("gt generators")
    sub = p.add_subparsers(dest="dataset", required=True)
    m = sub.add_parser("mot17")
    m.add_argument("--seq-root", required=True)
    m.add_argument("--out", required=True)
    c = sub.add_parser("crowdhuman")
    c.add_argument("--data-root", required=True)
    c.add_argument("--ann", required=True)
    c.add_argument("--out", required=True)
    b = sub.add_parser("bdd100k")
    b.add_argument("--ann-dir", required=True)
    b.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.dataset == "mot17":
        gen_mot17(args.seq_root, args.out)
    elif args.dataset == "crowdhuman":
        gen_crowdhuman(args.data_root, args.ann, args.out)
    else:
        gen_bdd100k(args.ann_dir, args.out)


if __name__ == "__main__":
    main()
