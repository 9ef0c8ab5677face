"""Box conversions, IoU and GIoU (counterpart of
``memotr_tpu/utils/box_ops.py``).

Everything broadcasts over leading batch dims; the pairwise variants take
``(..., N, 4)`` x ``(..., M, 4)`` -> ``(..., N, M)`` and the ``_pairwise``
ones aligned ``(..., 4)`` x ``(..., 4)`` -> ``(...)``.  Degenerate boxes are
guarded by an epsilon denominator, as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-9


def box_xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def box_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], -1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, (..., N, 4) -> (..., N)."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou_union(boxes1: torch.Tensor, boxes2: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise IoU and union of xyxy boxes -> (..., N, M) each."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp(min=_EPS), union


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor
                        ) -> torch.Tensor:
    """Pairwise GIoU of xyxy boxes -> (..., N, M)."""
    iou, union = box_iou_union(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=_EPS)


def box_iou_pairwise(boxes1: torch.Tensor, boxes2: torch.Tensor
                     ) -> torch.Tensor:
    """IoU of aligned xyxy boxes, (..., 4) x (..., 4) -> (...)."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    return inter / union.clamp(min=_EPS)


def generalized_box_iou_pairwise(boxes1: torch.Tensor, boxes2: torch.Tensor
                                 ) -> torch.Tensor:
    """GIoU of aligned xyxy boxes, (..., 4) x (..., 4) -> (...)."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    iou = inter / union.clamp(min=_EPS)
    lt_c = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb_c = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh_c = (rb_c - lt_c).clamp(min=0.0)
    area_c = wh_c[..., 0] * wh_c[..., 1]
    return iou - (area_c - union) / area_c.clamp(min=_EPS)
