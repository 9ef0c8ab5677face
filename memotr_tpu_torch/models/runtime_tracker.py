"""Streaming track lifecycle over the slot bank (counterpart of
``memotr_tpu/models/runtime_tracker.py``).

- live slots absorb the frame's track-query outputs;
- ``disappear_time`` counts frames whose score at the track's label is below
  TRACK_SCORE_THRESH; reaching MISS_TOLERANCE kills the slot (id -> -1);
- detection queries scoring >= DET_SCORE_THRESH are newborn candidates,
  numbered from the per-row ``next_id`` in detection-query order;
- a newborn's query embedding is ``queries[-1]``, the *input* of the last
  decoder layer; its reference is ``last_ref_pts``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..structures.track_state import (TrackState, insert_tracks,
                                      overflow_count)
from ..utils.misc import logits_to_scores


def update_tracked_slots(state: TrackState, model_out: Dict,
                         n_det: int) -> TrackState:
    gate = state.mask[..., None]
    return state.replace(
        boxes=torch.where(gate, model_out["pred_boxes"][:, n_det:], state.boxes),
        logits=torch.where(gate, model_out["pred_logits"][:, n_det:],
                           state.logits),
        output_embed=torch.where(gate, model_out["outputs"][:, n_det:],
                                 state.output_embed),
    )


def runtime_lifecycle(state: TrackState, track_score_thresh: float,
                      miss_tolerance: int) -> TrackState:
    scores = logits_to_scores(state.logits)
    label_score = torch.gather(
        scores, -1, state.labels.clamp(min=0).long()[..., None])[..., 0]
    low = label_score < track_score_thresh
    disappear = torch.where(state.mask & low, state.disappear_time + 1,
                            torch.zeros_like(state.disappear_time))
    last_appear = torch.where((state.mask & ~low)[..., None], state.boxes,
                              state.last_appear_boxes)
    dead = disappear >= miss_tolerance
    ids = torch.where(state.mask & dead, torch.full_like(state.ids, -1),
                      state.ids)
    return state.replace(disappear_time=disappear, ids=ids,
                         last_appear_boxes=last_appear,
                         mask=state.mask & ~dead)


def newborn_candidates(state: TrackState, model_out: Dict, n_det: int,
                       det_score_thresh: float) -> Tuple[Dict, torch.Tensor]:
    det_logits = model_out["pred_logits"][:, :n_det]
    det_scores = logits_to_scores(det_logits)
    born = det_scores.amax(dim=-1) >= det_score_thresh              # (B, Nd)
    born_i = born.to(torch.int32)
    rank = torch.cumsum(born_i, dim=1, dtype=torch.int32) - 1
    ids = torch.where(born, state.next_id[:, None] + rank,
                      torch.full_like(rank, -1))
    next_id = state.next_id + born_i.sum(dim=1, dtype=torch.int32)

    newborn_embed = model_out["queries"][-1][:, :n_det]
    c = newborn_embed.shape[-1]
    if model_out["det_query_embed"].shape[-1] == 2 * c:
        # D-DETR: positional half from the learned det queries
        pos_half = model_out["det_query_embed"][None, :, :c].expand_as(
            newborn_embed)
        newborn_embed = torch.cat([pos_half, newborn_embed], dim=-1)
    outputs = model_out["outputs"][:, :n_det]
    cand = {
        "mask": born,
        "ids": ids,
        "labels": det_scores.argmax(dim=-1).to(torch.int32),
        "logits": det_logits,
        "boxes": model_out["pred_boxes"][:, :n_det],
        "ref_pts": model_out["last_ref_pts"][:, :n_det],
        "output_embed": outputs,
        "query_embed": newborn_embed,
        "disappear_time": torch.zeros_like(ids),
        "last_output": outputs,
        "long_memory": newborn_embed[..., -c:],
        "last_appear_boxes": model_out["pred_boxes"][:, :n_det],
    }
    return cand, next_id


def runtime_tracker_step(state: TrackState, model_out: Dict, n_det: int,
                         det_score_thresh: float, track_score_thresh: float,
                         miss_tolerance: int
                         ) -> Tuple[TrackState, torch.Tensor]:
    """Absorb outputs, kill, spawn, merge.  Returns the new state and the
    (B,) count of newborn candidates dropped for want of a free slot."""
    state = update_tracked_slots(state, model_out, n_det)
    state = runtime_lifecycle(state, track_score_thresh, miss_tolerance)
    cand, next_id = newborn_candidates(state, model_out, n_det,
                                       det_score_thresh)
    state = state.replace(next_id=next_id)
    state = state.select(state.ids >= 0)      # eval keeps identified slots
    return insert_tracks(state, cand), overflow_count(state, cand)
