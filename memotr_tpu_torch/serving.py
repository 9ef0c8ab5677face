"""Serving export: the streaming step as a self-contained artifact
(counterpart of ``memotr_tpu/serving.py``).

``export_streaming`` traces the streaming frame step with
``torch.export`` at static shapes: uint8 frames normalized inside the
graph, the model forward, the runtime tracker's lifecycle, the query
updater and ``pack_results``.  The graph keeps the eager ATen ops (no
decompositions), and K1 and K2 stay one op node each
(``torch.ops.memotr_tpu_torch.msda_fwd`` / ``window_attn_fwd``,
``ops/library.py``), so a serving host runs the same kernels as the live
step.  The weights travel inside the program as its parameters.

Artifact layout (``<outdir>/``):

- ``step.pt2``        — ``torch.export.save`` of the step, calling
  convention ``(images, mask, *state_leaves) -> (packed, *state_leaves')``;
- ``init_state.npz``  — the fresh ``TrackState`` leaves in field order
  (``leaf_0`` ...);
- ``manifest.json``   — canvas, batch, slots, input dtype, thresholds, the
  packed-row layout, the leaf count and the platform the program was
  exported for.

The packed per-frame result is the pipelined submit path's
(``engine/submit.pack_results``): one ``(B, S, 9)`` float32 tensor
``[id, label, cx, cy, w, h, score, alive, overflow]``, a single device
fetch a frame, which aliases no state leaf.

``ServingRuntime`` needs only torch, numpy and the op registration module:
it imports nothing of the model code.  It runs on the artifact's platform
and raises where that device is absent.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from .ops import library  # noqa: F401  (registers the ops the program holds)

PACKED_LAYOUT = ["id", "label", "cx", "cy", "w", "h", "score", "alive",
                 "slot_overflow"]


class StreamingStep(torch.nn.Module):
    """``(images, mask, *state_leaves) -> (packed, *state_leaves')``: one
    streaming frame of ``model`` with the lifecycle's thresholds fixed.
    uint8 images are ImageNet-normalized inside the graph; the position
    maps are computed inside it too (no eval cache)."""

    def __init__(self, model, thresholds: Dict):
        super().__init__()
        self.model = model
        self.thresholds = thresholds

    def forward(self, images, mask, *leaves):
        from .engine.submit import normalize_uint8, pack_results
        from .models.frame_step import eval_frame_step
        from .structures.track_state import TrackState
        state = TrackState(*leaves)
        if images.dtype == torch.uint8:
            images = normalize_uint8(images)
        th = self.thresholds
        results, state = eval_frame_step(
            self.model, images, mask, state, th["det"], th["track"],
            th["miss_tolerance"])
        return (pack_results(results),) + tuple(
            getattr(state, f.name) for f in dataclasses.fields(state))


def export_streaming(config: dict, state_dict: Dict[str, torch.Tensor],
                     outdir: str, canvas_hw: Tuple[int, int] | None = None,
                     batch: int = 1, input_dtype: torch.dtype = torch.uint8,
                     device: torch.device | str = "cuda") -> str:
    """Export the streaming step of ``config`` with the weights
    ``state_dict`` (loaded strictly) to ``outdir``, traced on ``device``
    (the GPU unless ``"cpu"`` is asked for).  Returns ``outdir``."""
    from .config import cfg_get
    from .engine.submit import resolve_device
    from .models.memotr import build_model
    from .structures.track_state import TrackState

    device = resolve_device(device)
    model = build_model(config)
    model.load_state_dict(state_dict)
    model.to(device).eval()
    h = int(canvas_hw[0] if canvas_hw else cfg_get(config, "EVAL_SHORT_SIDE"))
    w = int(canvas_hw[1] if canvas_hw else cfg_get(config, "EVAL_MAX_SIDE"))
    slots = int(cfg_get(config, "TRACK_SLOTS"))
    thresholds = {
        "det": float(config["DET_SCORE_THRESH"]),
        "track": float(config["TRACK_SCORE_THRESH"]),
        "miss_tolerance": int(config["MISS_TOLERANCE"]),
    }
    state0 = TrackState.empty(batch, slots, model.hidden_dim,
                              model.num_classes, use_dab=model.use_dab,
                              device=device)
    leaves0 = [getattr(state0, f.name) for f in dataclasses.fields(state0)]
    images = torch.zeros((batch, h, w, 3), dtype=input_dtype, device=device)
    mask = torch.zeros((batch, h, w), dtype=torch.bool, device=device)
    with torch.no_grad():
        program = torch.export.export(StreamingStep(model, thresholds),
                                      (images, mask, *leaves0), strict=False)

    os.makedirs(outdir, exist_ok=True)
    torch.export.save(program, os.path.join(outdir, "step.pt2"))
    np.savez(os.path.join(outdir, "init_state.npz"),
             **{f"leaf_{i}": leaf.cpu().numpy()
                for i, leaf in enumerate(leaves0)})
    manifest = {
        "canvas_hw": [h, w], "batch": batch, "track_slots": slots,
        "input_dtype": str(input_dtype).removeprefix("torch."),
        "thresholds": thresholds, "packed_layout": PACKED_LAYOUT,
        "n_state_leaves": len(leaves0), "platforms": [device.type],
        "result_score_thresh": float(cfg_get(config, "RESULT_SCORE_THRESH",
                                             0.5)),
    }
    with open(os.path.join(outdir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return outdir


class ServingRuntime:
    """Run an exported streaming-step artifact (no model code needed).

    >>> rt = ServingRuntime.load("artifact/")
    >>> rows = rt.step(frame_u8, valid_mask)   # (S, 9) float32 per frame
    >>> rt.reset()                             # next sequence
    """

    def __init__(self, program, init_leaves, manifest: Dict):
        self.manifest = manifest
        self.device = torch.device(manifest["platforms"][0], 0) \
            if manifest["platforms"][0] == "cuda" else torch.device("cpu")
        self._step = program.module()
        self._init_leaves = [torch.from_numpy(leaf).to(self.device)
                             for leaf in init_leaves]
        self._leaves = None
        self.reset()

    @classmethod
    def load(cls, outdir: str) -> "ServingRuntime":
        """Load ``outdir``; raises when the artifact's platform is not
        here (a ``cuda`` artifact on a machine without a card)."""
        with open(os.path.join(outdir, "manifest.json")) as f:
            manifest = json.load(f)
        platform = manifest["platforms"][0]
        if platform == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{outdir} was exported for cuda and there is "
                               "no CUDA device here; export it again with "
                               "device='cpu' to serve on the CPU")
        if platform not in ("cuda", "cpu"):
            raise ValueError(f"unknown platform {platform!r} in {outdir}")
        program = torch.export.load(os.path.join(outdir, "step.pt2"))
        with np.load(os.path.join(outdir, "init_state.npz")) as z:
            leaves = [z[f"leaf_{i}"]
                      for i in range(manifest["n_state_leaves"])]
        return cls(program, leaves, manifest)

    def reset(self):
        """Fresh track state (start of a new sequence)."""
        self._leaves = [leaf.clone() for leaf in self._init_leaves]

    @torch.inference_mode()
    def step(self, image: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """One frame -> ``(S, 9)`` packed rows (see ``PACKED_LAYOUT``), or
        ``(B, S, 9)`` for an artifact of batch B.  ``image`` is
        ``(H, W, 3)`` (or ``(B, H, W, 3)``) of the manifest's input dtype;
        ``mask`` is ``(H, W)`` bool, True = padding."""
        batch = self.manifest["batch"]
        if image.ndim == 3:
            image, mask = image[None], mask[None]
        if image.shape[0] != batch:
            raise ValueError(f"artifact was exported for batch={batch}, got "
                             f"{image.shape[0]}")
        images = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        masks = torch.from_numpy(np.ascontiguousarray(mask)).to(self.device)
        out = self._step(images, masks, *self._leaves)
        packed, self._leaves = out[0], list(out[1:])
        rows = packed.cpu().numpy()
        return rows[0] if batch == 1 else rows
