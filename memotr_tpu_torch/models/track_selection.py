"""Training-time active-track selection over the fixed slot bank
(counterpart of ``memotr_tpu/models/track_selection.py``).

- Default path (no augmentation): previous tracks, newborn tracks and
  unmatched detections stay if their score exceeds ``UPDATE_THRESH`` or they
  carry an identity; a track whose IoU against its GT fell below 0.5 loses
  its identity (id -1) but stays as a hard-negative query.
- TP-drop: live tracks (IoU > 0.5, id >= 0) are dropped at random.
- FP-insert: for each live track picked with probability
  ``fp_insert_ratio``, the unmatched detection that overlaps it most is
  added as a false-positive query.
- A batch row left with no active track gets one random "fake" track (id
  -2) in slot 0.

Candidates go into free slots newborn tracks first; overflow is dropped.
Every random draw comes from the ``torch.Generator`` the caller passes (on
the state's device).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..structures.track_state import TrackState, insert_tracks
from ..utils import box_ops
from ..utils.misc import logits_to_scores


def _scores(logits: torch.Tensor) -> torch.Tensor:
    return logits_to_scores(logits.float()).amax(dim=-1)


def _fp_keep(state: TrackState, new_cand: Dict, um_cand: Dict,
             new_keep: torch.Tensor, generator: torch.Generator,
             fp_insert_ratio: float) -> torch.Tensor:
    """(B, Nd) unmatched detections to insert as false positives: for each
    live track picked with probability ``fp_insert_ratio``, the unmatched
    detection of highest IoU with it."""
    dev = state.mask.device
    sel_prev = state.mask & (torch.rand(state.mask.shape, generator=generator,
                                        device=dev) < fp_insert_ratio)
    sel_new = new_keep & (torch.rand(new_keep.shape, generator=generator,
                                     device=dev) < fp_insert_ratio)
    sel_boxes = torch.cat([state.boxes, new_cand["boxes"]], dim=1)
    sel_mask = torch.cat([sel_prev, sel_new], dim=1)          # (B, S+G)
    iou, _ = box_ops.box_iou_union(
        box_ops.box_cxcywh_to_xyxy(um_cand["boxes"]),
        box_ops.box_cxcywh_to_xyxy(sel_boxes))                # (B, Nd, S+G)
    iou = torch.where(sel_mask[:, None, :] & um_cand["mask"][:, :, None],
                      iou, torch.full_like(iou, -1.0))
    best_um = iou.argmax(dim=1)                               # (B, S+G)
    hit = (iou.amax(dim=1) > -1.0).to(torch.int8)
    fp = torch.zeros(um_cand["mask"].shape, dtype=torch.int8, device=dev)
    fp = fp.scatter_reduce(1, best_um, hit, reduce="amax")
    return fp.bool() & um_cand["mask"]


def select_active_tracks_train(state: TrackState, new_cand: Dict,
                               um_cand: Dict, generator: torch.Generator,
                               update_threshold: float,
                               tp_drop_ratio: float = 0.0,
                               fp_insert_ratio: float = 0.0,
                               no_augment: bool = False) -> TrackState:
    b = state.mask.shape[0]
    dev = state.mask.device
    if tp_drop_ratio == 0.0 and fp_insert_ratio == 0.0:
        # default path
        keep_prev = state.mask & ((_scores(state.logits) > update_threshold)
                                  | (state.ids >= 0))
        state = state.select(keep_prev)
        state = state.replace(ids=torch.where(
            state.mask & (state.iou < 0.5), torch.full_like(state.ids, -1),
            state.ids))
        new_ids = torch.where(new_cand["iou"] < 0.5,
                              torch.full_like(new_cand["ids"], -1),
                              new_cand["ids"])
        um_keep = um_cand["mask"] & (_scores(um_cand["logits"])
                                     > update_threshold)
        cand = {k: torch.cat([new_cand[k], um_cand[k]], dim=1)
                for k in new_cand}
        cand["mask"] = torch.cat([new_cand["mask"], um_keep], dim=1)
        cand["ids"] = torch.cat([new_ids, um_cand["ids"]], dim=1)
        state = insert_tracks(state, cand)
    else:
        # augmented path
        keep_prev = state.mask & (state.iou > 0.5) & (state.ids >= 0)
        state = state.select(keep_prev)
        new_keep = new_cand["mask"] & (new_cand["iou"] > 0.5) \
            & (new_cand["ids"] >= 0)
        if tp_drop_ratio > 0.0 and not no_augment:
            drop_prev = torch.rand(state.mask.shape, generator=generator,
                                   device=dev) <= tp_drop_ratio
            state = state.select(~drop_prev)
            drop_new = torch.rand(new_keep.shape, generator=generator,
                                  device=dev) <= tp_drop_ratio
            new_keep = new_keep & ~drop_new
        fp_keep = torch.zeros_like(um_cand["mask"])
        if fp_insert_ratio > 0.0 and not no_augment:
            fp_keep = _fp_keep(state, new_cand, um_cand, new_keep, generator,
                               fp_insert_ratio)
        cand = {k: torch.cat([new_cand[k], um_cand[k]], dim=1)
                for k in new_cand}
        cand["mask"] = torch.cat([new_keep, fp_keep], dim=1)
        state = insert_tracks(state, cand)

    # fake track in slot 0 of every row with no active track
    none_active = ~state.mask.any(dim=1)                      # (B,)

    def normal(*shape):
        return torch.randn((b,) + shape, generator=generator, device=dev)

    def put0(arr, val):
        w = none_active.view((b,) + (1,) * (arr.dim() - 1))
        first = torch.cat([val.to(arr.dtype)[:, None], arr[:, 1:]], dim=1)
        return torch.where(w, first, arr)

    qdim = state.query_embed.shape[-1]
    c = state.output_embed.shape[-1]
    fake_out = normal(c)
    minus2 = torch.full((b,), -2, dtype=torch.int32, device=dev)
    return state.replace(
        mask=put0(state.mask, torch.ones(b, dtype=torch.bool, device=dev)),
        ids=put0(state.ids, minus2),
        matched_idx=put0(state.matched_idx, minus2),
        query_embed=put0(state.query_embed, normal(qdim)),
        output_embed=put0(state.output_embed, fake_out),
        ref_pts=put0(state.ref_pts, normal(4)),
        boxes=put0(state.boxes, normal(4)),
        logits=put0(state.logits, normal(state.logits.shape[-1])),
        iou=put0(state.iou, torch.zeros(b, device=dev)),
        last_output=put0(state.last_output, fake_out),
        long_memory=put0(state.long_memory, normal(c)),
    )
