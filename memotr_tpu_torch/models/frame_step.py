"""Per-frame steps over ``TrackState`` (counterpart of
``memotr_tpu/models/frame_step.py``): the training frame (forward ->
losses -> track selection -> memory update) and the streaming frame
(forward -> lifecycle -> memory update)."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..structures.track_state import TrackState
from ..utils.misc import logits_to_scores
from .criterion import ClipCriterion, FrameGT
from .dropout import dropout_seed
from .runtime_tracker import runtime_tracker_step
from .track_selection import select_active_tracks_train


def model_forward(model, images: torch.Tensor, mask: torch.Tensor,
                  state: TrackState, eval_ctx: Optional[Dict] = None
                  ) -> Dict[str, torch.Tensor]:
    return model(images, mask, state.query_embed, state.ref_pts, state.mask,
                 eval_ctx)


def apply_query_updater(updater, state: TrackState) -> TrackState:
    upd = updater(state.query_embed, state.ref_pts, state.logits, state.boxes,
                  state.output_embed, state.last_output, state.long_memory,
                  state.mask)
    return state.replace(**upd)


def train_frame_step(model, criterion: ClipCriterion, images: torch.Tensor,
                     mask: torch.Tensor, gt: FrameGT, state: TrackState,
                     generator: torch.Generator, update_threshold: float,
                     tp_drop_ratio: float = 0.0, fp_insert_ratio: float = 0.0,
                     no_augment: bool = False, postprocess: bool = True,
                     distill: Optional[Callable] = None,
                     outputs: Optional[Dict] = None,
                     dropout_seeds: Optional[Tuple[int, int]] = None
                     ) -> Tuple[Dict, torch.Tensor, TrackState]:
    """One training frame -> (loss dict, n_gts (B,), next TrackState).
    ``postprocess=False`` (a clip's last frame) skips the selection and the
    query updater, whose results no later frame would read.
    ``distill(out, images, mask)``, when given, returns the frame's
    teacher->student terms (``engine/trainer.py: distill_frame_losses``),
    which join the loss dict under their own names.  ``outputs``, when
    given, receives the decoder's ``pred_logits``, ``pred_boxes`` and
    ``last_ref_pts``, detached (the ``VISUALIZE`` dumps).
    ``dropout_seeds``: (the forward's, the query updater's) dropout seeds,
    as JAX draws separate keys for the two (``models/dropout.py``); None:
    no dropout."""
    model_seed, updater_seed = dropout_seeds or (None, None)
    with dropout_seed(model_seed):
        out = model_forward(model, images, mask, state)
    if outputs is not None:
        outputs.update({k: out[k].detach() for k in
                        ("pred_logits", "pred_boxes", "last_ref_pts")})
    dterms = {} if distill is None else distill(out, images, mask)
    losses, n_gts, state, new_cand, um_cand = criterion.process_frame(
        out, state, gt)
    losses = dict(losses, **dterms)
    if postprocess:
        state = select_active_tracks_train(
            state, new_cand, um_cand, generator, update_threshold,
            tp_drop_ratio, fp_insert_ratio, no_augment)
        with dropout_seed(updater_seed):
            state = apply_query_updater(model.query_updater, state)
    return losses, n_gts, state


def eval_frame_step(model, images: torch.Tensor, mask: torch.Tensor,
                    state: TrackState, det_score_thresh: float,
                    track_score_thresh: float, miss_tolerance: int,
                    eval_ctx: Optional[Dict] = None
                    ) -> Tuple[Dict[str, torch.Tensor], TrackState]:
    """Returns (results for the writer, next TrackState).  ``results`` holds
    the post-update slot tensors plus ``slot_overflow`` (B,), the newborn
    candidates dropped because every slot was taken.  ``eval_ctx``: the
    eval cache's constants for ``mask`` (``models/eval_cache.py``)."""
    out = model_forward(model, images, mask, state, eval_ctx)
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
