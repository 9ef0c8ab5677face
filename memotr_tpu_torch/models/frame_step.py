"""One streaming frame: forward -> lifecycle -> memory update (counterpart of
``eval_frame_step`` in ``memotr_tpu/models/frame_step.py``; the training
step is a later slice of the port)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..structures.track_state import TrackState
from ..utils.misc import logits_to_scores
from .runtime_tracker import runtime_tracker_step


def model_forward(model, images: torch.Tensor, mask: torch.Tensor,
                  state: TrackState) -> Dict[str, torch.Tensor]:
    return model(images, mask, state.query_embed, state.ref_pts, state.mask)


def apply_query_updater(updater, state: TrackState) -> TrackState:
    upd = updater(state.query_embed, state.ref_pts, state.logits, state.boxes,
                  state.output_embed, state.last_output, state.long_memory,
                  state.mask)
    return state.replace(**upd)


def eval_frame_step(model, images: torch.Tensor, mask: torch.Tensor,
                    state: TrackState, det_score_thresh: float,
                    track_score_thresh: float, miss_tolerance: int
                    ) -> Tuple[Dict[str, torch.Tensor], TrackState]:
    """Returns (results for the writer, next TrackState).  ``results`` holds
    the post-update slot tensors plus ``slot_overflow`` (B,), the newborn
    candidates dropped because every slot was taken."""
    out = model_forward(model, images, mask, state)
    state, overflow = runtime_tracker_step(
        state, out, model.n_det_queries, det_score_thresh,
        track_score_thresh, miss_tolerance)
    state = apply_query_updater(model.query_updater, state)
    results = {
        "ids": state.ids,
        "labels": state.labels,
        "boxes": state.boxes,
        "scores": logits_to_scores(state.logits).amax(dim=-1),
        "mask": state.mask,
        "slot_overflow": overflow,
    }
    return results, state
