"""Clip augmentations on the host (counterpart of
``memotr_tpu/data/transforms.py``, PIL + numpy + cv2).

Each transform takes ``(imgs, infos, rng)``: ``imgs`` a list of PIL images
(one per frame of the clip), ``infos`` a list of dicts with numpy "boxes"
(N, 4) xyxy pixels, "ids", "labels" and "areas"; ``MultiNormalize`` turns
them into float32 HWC arrays and normalized cxcywh boxes.  Every random
decision is made once per clip, so all frames stay consistent.

``rng`` holds the two generators a clip draws from.  ``GLOBAL_RNG`` is the
process-wide ``random`` and ``np.random``: with it every transform makes
the same draws in the same order as the JAX package's, so that under the
same ``random.seed`` / ``np.random.seed`` both give the same clip.  The
threaded loader passes per-batch generators when it runs more than one
worker (``data/loader.py``).  PIL and cv2 are imported on first use.
"""
from __future__ import annotations

import copy
import random
from math import floor
from typing import Any, NamedTuple, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


class HostRNG(NamedTuple):
    """``py`` has the API of the ``random`` module (``random``, ``randint``,
    ``choice``), ``numpy`` that of ``np.random`` (``uniform``,
    ``randint``)."""
    py: Any
    numpy: Any


GLOBAL_RNG = HostRNG(random, np.random)


def seeded_rng(*entropy: int) -> HostRNG:
    """Generators of their own, seeded from ``entropy``."""
    seed = int(np.random.SeedSequence(list(entropy)).generate_state(1)[0])
    return HostRNG(random.Random(seed), np.random.RandomState(seed))


class MultiCompose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, imgs, infos, rng: HostRNG = GLOBAL_RNG):
        for t in self.transforms:
            imgs, infos = t(imgs, infos, rng)
        return imgs, infos


class MultiRandomSelect:
    def __init__(self, transform1, transform2, p: float = 0.5):
        self.transform1, self.transform2, self.p = transform1, transform2, p

    def __call__(self, imgs, infos, rng: HostRNG = GLOBAL_RNG):
        if rng.py.random() < self.p:
            return self.transform1(imgs, infos, rng)
        return self.transform2(imgs, infos, rng)


class MultiRandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, imgs, infos, rng: HostRNG = GLOBAL_RNG):
        import PIL.Image
        if rng.py.random() >= self.p:
            return imgs, infos
        out_imgs, out_infos = [], []
        for img, info in zip(imgs, infos):
            w = img.width
            img = img.transpose(PIL.Image.FLIP_LEFT_RIGHT)
            if len(info["boxes"]) > 0:
                b = info["boxes"]
                info["boxes"] = np.stack(
                    [w - b[:, 2], b[:, 1], w - b[:, 0], b[:, 3]], axis=-1)
            out_imgs.append(img)
            out_infos.append(info)
        return out_imgs, out_infos


def _short_side_hw(wh: Tuple[int, int], short: int, max_size) -> Tuple[int, int]:
    w, h = wh
    if max_size is not None:
        mn, mx = float(min(w, h)), float(max(w, h))
        if mx / mn * short > max_size:
            short = int(floor(max_size * mn / mx))
    if w < h:
        return int(round(short * h / w)), short
    return short, int(round(short * w / h))


class MultiRandomResize:
    """Short-side resize to a size drawn from ``sizes`` (or to a drawn
    ``(w, h)`` pair), the long side capped at ``max_size``."""

    def __init__(self, sizes: Sequence, max_size=None):
        self.sizes = sizes
        self.max_size = max_size

    def __call__(self, imgs, infos, rng: HostRNG = GLOBAL_RNG):
        import PIL.Image
        size = rng.py.choice(self.sizes)
        out_imgs, out_infos = [], []
        for img, info in zip(imgs, infos):
            if isinstance(size, (list, tuple)):
                new_h, new_w = size[1], size[0]
            else:
                new_h, new_w = _short_side_hw(img.size, size, self.max_size)
            resized = img.resize((new_w, new_h), PIL.Image.BILINEAR)
            rw, rh = new_w / img.width, new_h / img.height
            if len(info["boxes"]) > 0:
                info["boxes"] = info["boxes"] * np.asarray([rw, rh, rw, rh],
                                                           np.float32)
                info["areas"] = info["areas"] * rw * rh
            out_imgs.append(resized)
            out_infos.append(info)
        return out_imgs, out_infos


class MultiRandomCrop:
    """A crop of drawn size and place; boxes clipped to it, and dropped
    when nothing is left.  ``overflow_bbox`` keeps the unclipped
    coordinates of the boxes kept."""

    def __init__(self, min_size: int, max_size: int, overflow_bbox: bool = False):
        self.min_size, self.max_size = min_size, max_size
        self.overflow_bbox = overflow_bbox

    def __call__(self, imgs, infos, rng: HostRNG = GLOBAL_RNG):
        w, h = imgs[0].size
        crop_w = rng.py.randint(self.min_size,
                                max(self.min_size, min(w, self.max_size)))
        crop_h = rng.py.randint(self.min_size,
                                max(self.min_size, min(h, self.max_size)))
        crop_w, crop_h = min(crop_w, w), min(crop_h, h)
        i = rng.py.randint(0, h - crop_h)
        j = rng.py.randint(0, w - crop_w)
        out_imgs, out_infos = [], []
        for img, info in zip(imgs, infos):
            img = img.crop((j, i, j + crop_w, i + crop_h))
            if len(info["boxes"]) > 0:
                b = info["boxes"] - np.asarray([j, i, j, i], np.float32)
                clipped = np.clip(b, 0, [crop_w, crop_h, crop_w, crop_h])
                keep = (clipped[:, 2] > clipped[:, 0]) \
                    & (clipped[:, 3] > clipped[:, 1])
                info["boxes"] = b[keep] if self.overflow_bbox else clipped[keep]
                for f in ("labels", "ids", "areas"):
                    info[f] = info[f][keep]
            out_imgs.append(img)
            out_infos.append(info)
        return out_imgs, out_infos


class MultiRandomShift:
    """Motion for a static image: each frame is a shifted, rescaled crop of
    the previous one; the clip may then be reversed."""

    def __init__(self, max_shift: int = 50):
        self.max_shift = max_shift

    def __call__(self, imgs, infos, rng: HostRNG = GLOBAL_RNG):
        import PIL.Image
        n = len(imgs)
        w, h = imgs[0].size
        xs = int(np.ceil(self.max_shift * rng.py.random())) \
            * rng.py.choice([-1, 1])
        ys = int(np.ceil(self.max_shift * rng.py.random())) \
            * rng.py.choice([-1, 1])
        out_imgs, out_infos = [imgs[0]], [infos[0]]
        for _ in range(1, n):
            y0, y1 = max(0, -ys), min(h, h - ys)
            x0, x1 = max(0, -xs), max(w, w - xs)
            prev = out_imgs[-1].copy()
            info = copy.deepcopy(out_infos[-1])
            region_w, region_h = int(x1 - x0), int(y1 - y0)
            img = prev.crop((int(x0), int(y0), int(x0) + region_w,
                             int(y0) + region_h))
            img = img.resize((w, h), PIL.Image.BILINEAR)
            if len(info["boxes"]) > 0:
                b = info["boxes"] - np.asarray([x0, y0, x0, y0], np.float32)
                b *= np.asarray([w / region_w, h / region_h] * 2, np.float32)
                b = np.clip(b, 0, [w, h, w, h])
                keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
                info["boxes"] = b[keep]
                for f in ("labels", "ids", "areas"):
                    info[f] = info[f][keep]
            out_imgs.append(img)
            out_infos.append(info)
        if rng.py.random() > 0.5:
            out_imgs.reverse()
            out_infos.reverse()
        return out_imgs, out_infos


class MultiHSV:
    """HSV jitter (YOLOX), one draw per clip."""

    def __init__(self, hgain=5, sgain=30, vgain=30):
        self.gains = (hgain, sgain, vgain)

    def __call__(self, imgs, infos, rng: HostRNG = GLOBAL_RNG):
        import cv2
        import PIL.Image
        augs = rng.numpy.uniform(-1, 1, 3) * np.asarray(self.gains)
        augs *= rng.numpy.randint(0, 2, 3)
        augs = augs.astype(np.int16)
        out = []
        for img in imgs:
            arr = np.asarray(img)
            hsv = cv2.cvtColor(arr, cv2.COLOR_RGB2HSV).astype(np.int16)
            hsv[..., 0] = (hsv[..., 0] + augs[0]) % 180
            hsv[..., 1] = np.clip(hsv[..., 1] + augs[1], 0, 255)
            hsv[..., 2] = np.clip(hsv[..., 2] + augs[2], 0, 255)
            out.append(PIL.Image.fromarray(
                cv2.cvtColor(hsv.astype(arr.dtype), cv2.COLOR_HSV2RGB)))
        return out, infos


class MultiNormalize:
    """uint8 PIL -> float32 HWC normalized; boxes -> normalized cxcywh."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, imgs, infos, rng: HostRNG = GLOBAL_RNG):
        out_imgs, out_infos = [], []
        for img, info in zip(imgs, infos):
            arr = np.asarray(img, np.float32) / 255.0
            arr = (arr - self.mean) / self.std
            h, w = arr.shape[:2]
            if len(info["boxes"]) > 0:
                b = info["boxes"]
                cxcywh = np.stack([(b[:, 0] + b[:, 2]) / 2,
                                   (b[:, 1] + b[:, 3]) / 2,
                                   b[:, 2] - b[:, 0],
                                   b[:, 3] - b[:, 1]], axis=-1)
                info["boxes"] = cxcywh / np.asarray([w, h, w, h], np.float32)
            out_imgs.append(arr)
            out_infos.append(info)
        return out_imgs, out_infos


class MultiReverseClip:
    def __init__(self, reverse: float = 0.0):
        self.reverse = reverse

    def __call__(self, imgs, infos, rng: HostRNG = GLOBAL_RNG):
        if rng.py.random() < self.reverse:
            imgs = list(imgs)[::-1]
            infos = list(infos)[::-1]
        return imgs, infos


MOTR_SCALES = [608, 640, 672, 704, 736, 768, 800, 832, 864, 896, 928, 960, 992]


def transforms_for_train(coco_size: bool = False, overflow_bbox: bool = False,
                         reverse_clip: float = 0.0, sizes=None,
                         max_size: int = 1536) -> MultiCompose:
    """The reference's training stack.  ``sizes`` (``TRAIN_SHORT_SIDES``)
    replaces the MOTR short-side scales with its own list and drops the
    resize-crop branch."""
    if sizes is not None:
        return MultiCompose([
            MultiRandomHorizontalFlip(),
            MultiRandomResize(sizes=list(sizes), max_size=max_size),
            MultiHSV(),
            MultiNormalize(),
            MultiReverseClip(reverse=reverse_clip),
        ])
    return MultiCompose([
        MultiRandomHorizontalFlip(),
        MultiRandomSelect(
            MultiRandomResize(sizes=MOTR_SCALES, max_size=1536),
            MultiCompose([
                MultiRandomResize([400, 500, 600] if coco_size
                                  else [800, 1000, 1200]),
                MultiRandomCrop(min_size=384 if coco_size else 800,
                                max_size=600 if coco_size else 1200,
                                overflow_bbox=overflow_bbox),
                MultiRandomResize(sizes=MOTR_SCALES, max_size=1536),
            ])),
        MultiHSV(),
        MultiNormalize(),
        MultiReverseClip(reverse=reverse_clip),
    ])


def transforms_for_eval() -> MultiCompose:
    return MultiCompose([
        MultiRandomResize(sizes=[800], max_size=1333),
        MultiNormalize(),
    ])
