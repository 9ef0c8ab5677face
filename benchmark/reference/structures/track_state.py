"""Fixed-shape track-slot state (counterpart of
``memotr_tpu/structures/track_state.py``).

Every per-object field is a ``(B, S, ...)`` tensor with a fixed slot count
``S``; a boolean ``mask`` marks occupied slots.  Birth, death and update are
masked writes, so the shapes never change from frame to frame (which keeps
the frame step capturable as one CUDA graph).  ``ref_pts`` is stored in
logit space.  Updates return new states; tensors are never written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

SLOT_FIELDS = (
    "mask", "ids", "labels", "disappear_time", "query_embed", "ref_pts",
    "logits", "boxes", "output_embed", "last_output", "long_memory",
    "last_appear_boxes",
)


@dataclasses.dataclass(frozen=True)
class TrackState:
    mask: torch.Tensor            # (B, S) bool, slot holds a live track
    ids: torch.Tensor             # (B, S) int32, -1 = no identity
    labels: torch.Tensor          # (B, S) int32
    disappear_time: torch.Tensor  # (B, S) int32
    next_id: torch.Tensor         # (B,) int32 monotonic id counter
    query_embed: torch.Tensor     # (B, S, C) DAB query embeddings
    ref_pts: torch.Tensor         # (B, S, 4) logit-space anchors
    logits: torch.Tensor          # (B, S, K)
    boxes: torch.Tensor           # (B, S, 4) normalized cxcywh
    output_embed: torch.Tensor    # (B, S, C)
    last_output: torch.Tensor     # (B, S, C)
    long_memory: torch.Tensor     # (B, S, C)
    last_appear_boxes: torch.Tensor  # (B, S, 4)

    @staticmethod
    def empty(batch_size: int, num_slots: int, hidden_dim: int,
              num_classes: int, dtype: torch.dtype = torch.float32,
              device: torch.device | str = "cpu") -> "TrackState":
        b, s, c = batch_size, num_slots, hidden_dim

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        def full(shape, val, dt):
            return torch.full(shape, val, dtype=dt, device=device)

        return TrackState(
            mask=zeros(b, s, dt=torch.bool),
            ids=full((b, s), -1, torch.int32),
            labels=zeros(b, s, dt=torch.int32),
            disappear_time=zeros(b, s, dt=torch.int32),
            next_id=zeros(b, dt=torch.int32),
            query_embed=zeros(b, s, c),
            ref_pts=zeros(b, s, 4),
            logits=full((b, s, num_classes), -10.0, dtype),
            boxes=zeros(b, s, 4),
            output_embed=zeros(b, s, c),
            last_output=zeros(b, s, c),
            long_memory=zeros(b, s, c),
            last_appear_boxes=zeros(b, s, 4),
        )

    def replace(self, **updates) -> "TrackState":
        return dataclasses.replace(self, **updates)

    def select(self, keep: torch.Tensor) -> "TrackState":
        """Kill slots where ``keep`` is False."""
        return self.replace(mask=self.mask & keep)


def overflow_count(state: TrackState, candidates: Dict) -> torch.Tensor:
    """(B,) int32: candidates that will NOT fit in free slots."""
    n_free = (~state.mask).sum(dim=1)
    n_cand = candidates["mask"].to(torch.int32).sum(dim=1)
    return (n_cand - n_free).clamp(min=0).to(torch.int32)


def insert_tracks(state: TrackState, candidates: Dict) -> TrackState:
    """Write candidate tracks into free slots.

    ``candidates`` maps slot-field names to (B, N, ...) tensors and must hold
    "mask" (B, N).  Candidates go, in candidate order, into free slots in
    slot order; those that do not fit are dropped.  Fields not given default
    to zeros (ids to -1).

    The JAX version scatters with ``mode="drop"``; torch has no such mode,
    so a dropped candidate is routed to a scratch slot S that is sliced off
    afterwards.  All shapes stay fixed.
    """
    b, s = state.mask.shape
    cmask = candidates["mask"]
    n = cmask.shape[1]
    # free slots in increasing slot order (stable sort: False < True)
    free_order = torch.sort(state.mask.to(torch.int8), dim=1,
                            stable=True).indices                     # (B, S)
    n_free = (~state.mask).sum(dim=1, keepdim=True)                  # (B, 1)
    rank = torch.cumsum(cmask.to(torch.int64), dim=1) - 1           # (B, N)
    ok = cmask & (rank < n_free)
    slot = torch.gather(free_order, 1, rank.clamp(0, s - 1))
    slot = torch.where(ok, slot, torch.full_like(slot, s))           # scratch

    updates = {}
    for f in SLOT_FIELDS:
        cur = getattr(state, f)
        if f in candidates:
            cand = candidates[f].to(cur.dtype)
        elif f == "ids":
            cand = torch.full((b, n) + cur.shape[2:], -1, dtype=cur.dtype,
                              device=cur.device)
        else:
            cand = torch.zeros((b, n) + cur.shape[2:], dtype=cur.dtype,
                               device=cur.device)
        pad = torch.zeros((b, 1) + cur.shape[2:], dtype=cur.dtype,
                          device=cur.device)
        ext = torch.cat([cur, pad], dim=1)                           # (B,S+1,..)
        idx = slot.view(b, n, *([1] * (cur.dim() - 2))).expand(cand.shape)
        updates[f] = ext.scatter(1, idx, cand)[:, :s]
    return state.replace(**updates)
