"""Clip criterion: tracking-aware detection losses over fixed-shape GTs
(counterpart of ``memotr_tpu/models/criterion.py``).

Per frame:

1. tracked slots absorb the frame's outputs, and each live slot finds its
   GT by identity (``matched_idx``, -1 if the identity vanished);
2. GTs that no live track covers are Hungarian-matched against the
   detection queries with cost ``5 L1 + 2 focal-class - 2 GIoU``;
3. the focal label loss runs over every unmasked query (background where
   no GT is assigned), L1 and GIoU over matched pairs; the trainer
   normalizes by the clip's GT count;
4. aux losses per decoder layer with re-matching; layers below
   ``merge_det_track_layer`` match against every GT and carry no track
   assignment;
5. matched detections become newborn candidates carrying the last decoder
   layer's input embedding, unmatched detections are collected for the
   FP-insert augmentation, and each tracked slot's IoU against its GT is
   refreshed for the query updater's gate.

Matching sees detached logits and boxes.  The cost matrices of every
decoder layer of a frame are built on the device first and solved in one
call of ``ops/hungarian.py``: one host copy per frame.  GTs arrive padded,
``FrameGT`` tensors of shape (B, G, ...) with a validity mask.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.hungarian import hungarian_cost_padded
from ..structures.track_state import TrackState
from ..utils import box_ops
from ..utils.misc import logits_to_scores


@dataclasses.dataclass(frozen=True)
class FrameGT:
    boxes: torch.Tensor   # (B, G, 4) normalized cxcywh
    labels: torch.Tensor  # (B, G) int
    ids: torch.Tensor     # (B, G) int
    mask: torch.Tensor    # (B, G) bool


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr (B, N, ...) indexed per row by idx (B, K) -> (B, K, ...)."""
    bidx = torch.arange(arr.shape[0], device=arr.device)[:, None]
    return arr[bidx, idx.long()]


def focal_class_cost(det_probs: torch.Tensor, gt_labels: torch.Tensor,
                     alpha: float = 0.25, gamma: float = 2.0
                     ) -> torch.Tensor:
    """(B, Nd, K) probabilities x (B, G) labels -> (B, G, Nd) focal cost."""
    pos = alpha * ((1 - det_probs) ** gamma) * (-torch.log(det_probs + 1e-8))
    neg = (1 - alpha) * (det_probs ** gamma) * (
        -torch.log(1 - det_probs + 1e-8))
    cost = (pos - neg).transpose(1, 2)                        # (B, K, Nd)
    lab = gt_labels.clamp(min=0).long()
    return torch.gather(cost, 1, lab[:, :, None].expand(-1, -1,
                                                        cost.shape[2]))


def match_cost_matrix(det_logits: torch.Tensor, det_boxes: torch.Tensor,
                      gt: FrameGT, w_class: float, w_bbox: float,
                      w_giou: float) -> torch.Tensor:
    """Matching cost (B, G, Nd)."""
    c_class = focal_class_cost(logits_to_scores(det_logits), gt.labels)
    c_bbox = (gt.boxes[:, :, None, :] - det_boxes[:, None, :, :]).abs().sum(-1)
    giou = box_ops.generalized_box_iou(box_ops.box_cxcywh_to_xyxy(gt.boxes),
                                       box_ops.box_cxcywh_to_xyxy(det_boxes))
    return w_bbox * c_bbox + w_class * c_class - w_giou * giou


def _invert_assignment(col4row: torch.Tensor, row_mask: torch.Tensor,
                       n_cols: int) -> torch.Tensor:
    """(B, G) row -> column assignment to (B, n_cols) column -> row, -1
    where unassigned.  Unassigned rows go to a scratch column, cut off."""
    b, g = col4row.shape
    idx = torch.where(row_mask & (col4row >= 0), col4row.long(),
                      torch.full_like(col4row.long(), n_cols))
    rows = torch.arange(g, dtype=torch.int32,
                        device=col4row.device).expand(b, g)
    out = torch.full((b, n_cols + 1), -1, dtype=torch.int32,
                     device=col4row.device)
    return out.scatter(1, idx, rows)[:, :n_cols]


def sigmoid_focal_loss(logits: torch.Tensor, targets_onehot: torch.Tensor,
                       valid: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Per-element focal BCE, mean over classes, summed over valid
    queries."""
    p = torch.sigmoid(logits)
    ce = logits.clamp(min=0) - logits * targets_onehot + torch.log1p(
        torch.exp(-logits.abs()))
    p_t = p * targets_onehot + (1 - p) * (1 - targets_onehot)
    loss = ce * ((1 - p_t) ** gamma)
    alpha_t = alpha * targets_onehot + (1 - alpha) * (1 - targets_onehot)
    per_query = (alpha_t * loss).mean(-1)                     # (B, N)
    return torch.where(valid, per_query, torch.zeros_like(per_query)).sum()


class ClipCriterion:
    """Stateless per-frame losses; the trainer sums the returned dicts over
    the clip and normalizes by the GT count."""

    def __init__(self, num_classes: int, n_det_queries: int,
                 w_match_class: float = 2.0, w_match_bbox: float = 5.0,
                 w_match_giou: float = 2.0, merge_det_track_layer: int = 0,
                 aux_weights=None, use_dab: bool = True,
                 hidden_dim: int = 256, aux_loss: bool = True):
        self.num_classes = num_classes
        self.n_det = n_det_queries
        self.w_match = (w_match_class, w_match_bbox, w_match_giou)
        self.merge_layer = merge_det_track_layer
        self.aux_weights = aux_weights
        self.use_dab = use_dab
        self.hidden_dim = hidden_dim
        self.aux_loss = aux_loss

    def _label_loss(self, logits, query_valid, q2gt, gt: FrameGT):
        lab = torch.gather(gt.labels.long(), 1, q2gt.clamp(min=0).long())
        lab = torch.where(q2gt >= 0, lab, torch.full_like(lab,
                                                          self.num_classes))
        onehot = F.one_hot(lab, self.num_classes + 1)[..., :-1].float()
        return sigmoid_focal_loss(logits, onehot, query_valid)

    def _box_loss(self, boxes, query_valid, q2gt, gt: FrameGT):
        matched = (q2gt >= 0) & query_valid                   # (B, N)
        gt_boxes = _take(gt.boxes, q2gt.clamp(min=0))         # (B, N, 4)
        zero = torch.zeros_like(boxes[..., 0])
        l1 = (boxes - gt_boxes).abs().sum(-1)
        giou = box_ops.generalized_box_iou_pairwise(
            box_ops.box_cxcywh_to_xyxy(boxes),
            box_ops.box_cxcywh_to_xyxy(gt_boxes))
        return (torch.where(matched, l1, zero).sum(),
                torch.where(matched, 1.0 - giou, zero).sum())

    def _match_all(self, model_out: Dict, gt: FrameGT,
                   untracked: torch.Tensor) -> torch.Tensor:
        """The final layer's and every aux layer's assignment, (L', B, G):
        index 0 the final layer (rows: untracked GTs), then aux layer i at
        i + 1 (rows: every GT below the merge layer, else untracked).  One
        host copy for all of them."""
        nd = self.n_det
        layers = [(model_out["pred_logits"], model_out["pred_boxes"],
                   untracked)]
        if self.aux_loss:
            for i in range(model_out["all_logits"].shape[0] - 1):
                rows = gt.mask if i < self.merge_layer else untracked
                layers.append((model_out["all_logits"][i],
                               model_out["all_boxes"][i], rows))
        with torch.no_grad():
            costs = torch.stack([
                match_cost_matrix(lg[:, :nd].float(), bx[:, :nd].float(), gt,
                                  *self.w_match) for lg, bx, _ in layers])
            rows = torch.stack([r for _, _, r in layers])
        return hungarian_cost_padded(costs, rows)

    def process_frame(self, model_out: Dict, state: TrackState, gt: FrameGT
                      ) -> Tuple[Dict, torch.Tensor, TrackState, Dict, Dict]:
        """Returns (loss dict, n_gts (B,), state with refreshed bookkeeping,
        newborn candidates, unmatched-detection candidates)."""
        nd = self.n_det
        b, g = gt.mask.shape

        # 1. tracked slots absorb the outputs and find their GT by identity
        gate = state.mask[..., None]
        state = state.replace(
            boxes=torch.where(gate, model_out["pred_boxes"][:, nd:],
                              state.boxes),
            logits=torch.where(gate, model_out["pred_logits"][:, nd:],
                               state.logits),
            output_embed=torch.where(gate, model_out["outputs"][:, nd:],
                                     state.output_embed))
        eq = ((state.ids[:, :, None] == gt.ids[:, None, :])
              & state.mask[:, :, None] & gt.mask[:, None, :]
              & (state.ids >= 0)[:, :, None])                 # (B, S, G)
        matched_idx = torch.where(eq.any(-1), eq.to(torch.int8).argmax(-1),
                                  torch.full_like(state.ids, -1, dtype=torch.int64))
        state = state.replace(matched_idx=matched_idx.to(torch.int32))
        untracked = gt.mask & ~eq.any(dim=1)                  # (B, G)

        # 2. Hungarian: untracked GTs x detection queries, every layer
        col4rows = self._match_all(model_out, gt, untracked)
        col4row = col4rows[0]
        det2gt = _invert_assignment(col4row, untracked, nd)   # (B, Nd)
        det_logits = model_out["pred_logits"][:, :nd]
        det_boxes = model_out["pred_boxes"][:, :nd]

        # 3. the final layer's losses
        q2gt = torch.cat([det2gt, state.matched_idx], dim=1)
        query_valid = ~model_out["query_mask"]
        losses = {"label_focal_loss": self._label_loss(
            model_out["pred_logits"].float(), query_valid, q2gt, gt)}
        losses["box_l1_loss"], losses["box_giou_loss"] = self._box_loss(
            model_out["pred_boxes"].float(), query_valid, q2gt, gt)

        # 4. aux layers (all but the last)
        if self.aux_loss:
            aux_focal = aux_l1 = aux_giou = 0.0
            no_track = torch.full_like(state.matched_idx, -1)
            for i in range(model_out["all_logits"].shape[0] - 1):
                a_logits = model_out["all_logits"][i].float()
                a_boxes = model_out["all_boxes"][i].float()
                rows = gt.mask if i < self.merge_layer else untracked
                a_det2gt = _invert_assignment(col4rows[i + 1], rows, nd)
                a_q2gt = torch.cat(
                    [a_det2gt, no_track if i < self.merge_layer
                     else state.matched_idx], dim=1)
                w = self.aux_weights[i] if self.aux_weights else 1.0
                aux_focal = aux_focal + w * self._label_loss(
                    a_logits, query_valid, a_q2gt, gt)
                a_l1, a_giou = self._box_loss(a_boxes, query_valid, a_q2gt,
                                              gt)
                aux_l1 = aux_l1 + w * a_l1
                aux_giou = aux_giou + w * a_giou
            losses["aux_label_focal_loss"] = aux_focal
            losses["aux_box_l1_loss"] = aux_l1
            losses["aux_box_giou_loss"] = aux_giou

        n_gts = gt.mask.sum(dim=1)                            # (B,)

        # 5a. newborn candidates: matched detections adopt the GT identity
        q = col4row.clamp(min=0)                              # (B, G)
        born = untracked                          # every valid row matched
        hd = self.hidden_dim
        det_embed = model_out["queries"][-1][:, :nd]
        if not self.use_dab:
            pos_half = model_out["det_query_embed"][None, :, :hd].expand(
                b, nd, hd).float()
            det_embed = torch.cat([pos_half, det_embed], dim=-1)
        new_embed = _take(det_embed, q)
        new_boxes = _take(det_boxes, q)
        new_iou = box_ops.box_iou_pairwise(
            box_ops.box_cxcywh_to_xyxy(new_boxes),
            box_ops.box_cxcywh_to_xyxy(gt.boxes))
        minus1 = torch.full_like(gt.ids, -1, dtype=torch.int32)
        det_out = model_out["outputs"][:, :nd]
        new_cand = {
            "mask": born,
            "ids": torch.where(born, gt.ids.to(torch.int32), minus1),
            "labels": gt.labels.to(torch.int32),
            "matched_idx": torch.where(
                born, torch.arange(g, dtype=torch.int32,
                                   device=born.device)[None], minus1),
            "query_embed": new_embed,
            "ref_pts": _take(model_out["last_ref_pts"][:, :nd], q),
            "output_embed": _take(det_out, q),
            "boxes": new_boxes,
            "logits": _take(det_logits, q),
            "iou": torch.where(born, new_iou, torch.zeros_like(new_iou)),
            "last_output": _take(det_out, q),
            "long_memory": new_embed if self.use_dab else new_embed[..., hd:],
        }

        # 5b. unmatched detections (FP-insert augmentation)
        um_ints = torch.full((b, nd), -1, dtype=torch.int32,
                             device=born.device)
        um_cand = {
            "mask": det2gt < 0,
            "ids": um_ints,
            "matched_idx": um_ints,
            "labels": torch.zeros_like(um_ints),
            "query_embed": det_embed,
            "ref_pts": model_out["init_ref_pts"][:, :nd],
            "output_embed": det_out,
            "boxes": det_boxes,
            "logits": det_logits,
            "iou": torch.zeros((b, nd), device=born.device),
            "last_output": det_out,
            "long_memory": det_embed if self.use_dab else det_embed[..., hd:],
        }

        # 5c. tracked slots' IoU against their GT (the updater's gate)
        has_gt = state.matched_idx >= 0
        track_gt_boxes = _take(gt.boxes, state.matched_idx.clamp(min=0))
        track_iou = box_ops.box_iou_pairwise(
            box_ops.box_cxcywh_to_xyxy(state.boxes),
            box_ops.box_cxcywh_to_xyxy(track_gt_boxes))
        state = state.replace(iou=torch.where(has_gt & state.mask, track_iou,
                                              state.iou))
        return losses, n_gts, state, new_cand, um_cand


def build_criterion(config: dict) -> ClipCriterion:
    from ..config import cfg_get, num_classes_for_dataset
    return ClipCriterion(
        num_classes=num_classes_for_dataset(config["DATASET"]),
        n_det_queries=config["NUM_DET_QUERIES"],
        w_match_class=cfg_get(config, "MATCH_COST_CLASS"),
        w_match_bbox=cfg_get(config, "MATCH_COST_BBOX"),
        w_match_giou=cfg_get(config, "MATCH_COST_GIOU"),
        merge_det_track_layer=cfg_get(config, "MERGE_DET_TRACK_LAYER"),
        aux_weights=cfg_get(config, "AUX_LOSS_WEIGHT"),
        use_dab=cfg_get(config, "USE_DAB"),
        hidden_dim=config["HIDDEN_DIM"],
        aux_loss=cfg_get(config, "AUX_LOSS"),
    )
