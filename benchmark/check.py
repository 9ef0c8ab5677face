"""What decides ``correct``: the program's outputs from the timed path
against the plain float32 reference (``benchmark/reference``, TF32 off),
after the window has closed.

For each step the seed sampled (step
0, from empty track slots, and a few more), with the uint8 frames, the
padding mask and the track state the program carried into that step:

- ``logit_rms`` / ``box_rms``: the root mean square of the gaps between
  the program's and the reference's forward (class logits; boxes,
  normalized) over every detection query and every live track query of
  every lane.  The reference computes the forward itself from the frames
  and the state.  (The largest gap is an extreme over some 23,000 logits
  whose bf16 tail comes within a factor of three of float8's: PERF.md has
  both readings);
- the tracker and query-updater stage, by itself: the reference's runtime
  tracker and query updater on the program's forward outputs and the
  state in.  ``state_mismatch`` counts slots whose occupancy, id, label
  or miss count differ from the program's next state or from the rows
  its writer got, and ``rows_gap`` is the largest gap of the written
  boxes and scores (both exact, limit 0: both sides decide on, and copy,
  the same float32 outputs); ``state_gap`` is the largest gap of the
  carried state's continuous fields over live slots (query embedding,
  anchor, long memory, last output: the query updater's work, in bf16
  in the program).

The reference follows the program step by step from the program's own
state at each sampled step (a sequence in float32 forks from one in
bfloat16 wherever a score crosses a threshold); step 0 starts from empty
slots and checks the start by itself, the stage check the hand-over
between steps.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
from typing import Dict, List

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from . import gen
from .reference import build, no_tf32

DISCRETE = ("mask", "ids", "labels", "disappear_time")
CONTINUOUS = ("query_embed", "ref_pts", "long_memory", "last_output",
              "boxes", "logits")


# ----------------------------------------------------------- lower precision
def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a per-tensor scale (its largest
    magnitude to e4m3's largest, 448), back in its dtype."""
    amax = t.detach().abs().amax().float().clamp(min=1e-12)
    scale = 448.0 / amax
    q = (t.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (q.to(t.dtype) - t).detach()


class FP8Products(TorchFunctionMode):
    """Every matrix product and convolution on float8 e4m3 inputs: the
    reference computed one precision below the configuration's bfloat16
    (the control that ``correct`` must refuse)."""

    FUNCS = {torch.nn.functional.linear, torch.nn.functional.conv2d,
             torch.matmul, torch.bmm, torch.einsum, torch.mm, torch.addmm,
             torch.baddbmm, torch.Tensor.__matmul__,
             torch.nn.functional.scaled_dot_product_attention}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.FUNCS:
            args = tuple(fake_fp8(a) if isinstance(a, torch.Tensor)
                         and a.is_floating_point() else a for a in args)
        return func(*args, **kwargs)


def precision(fp8: bool):
    return FP8Products() if fp8 else contextlib.nullcontext()


# ---------------------------------------------------------------- reference
def reference_model(config: dict, weights: Dict, device):
    model = build(config).to(device)
    model.load_state_dict(weights)
    return model.eval()


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- streaming
def _ref_state(fields: Dict[str, torch.Tensor]):
    """The reference's track state from the program's carried fields."""
    from .reference.structures.track_state import TrackState
    return TrackState(**{f.name: fields[f.name]
                         for f in dataclasses.fields(TrackState)})


def _gap(a: torch.Tensor, b: torch.Tensor, rows: torch.Tensor) -> float:
    if not bool(rows.any()):
        return 0.0
    return float((a.float() - b.float()).abs()[rows].max())


def _rms(a: torch.Tensor, b: torch.Tensor, rows: torch.Tensor) -> float:
    if not bool(rows.any()):
        return 0.0
    return float((a.float() - b.float())[rows].pow(2).mean().sqrt())


def reference_forward(ref, entry: Dict, n_det: int, fp8: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """The reference's forward of a sampled step, lane by lane (B=1 keeps
    its memory small): pred_logits, pred_boxes and the other fields the
    tracker reads."""
    images = gen.normalize_uint8(entry["images"])
    st = entry["state_in"]
    outs: Dict[str, List[torch.Tensor]] = {}
    with torch.no_grad(), no_tf32(), precision(fp8):
        for lane in range(images.shape[0]):
            s = slice(lane, lane + 1)
            out = ref(images[s], entry["mask"][s], st["query_embed"][s],
                      st["ref_pts"][s], st["mask"][s])
            for k in ("pred_logits", "pred_boxes", "outputs", "last_ref_pts"):
                outs.setdefault(k, []).append(out[k])
            outs.setdefault("queries_last", []).append(out["queries"][-1])
            det = out["det_query_embed"]
    res = {k: torch.cat(v) for k, v in outs.items()}
    res["det_query_embed"] = det
    return res


def reference_stage(ref, state_in: Dict, forward: Dict, config: dict,
                    fp8: bool = False):
    """The reference's tracker and query updater on given forward outputs
    and state -> its next state."""
    from .reference.models.frame_step import apply_query_updater
    from .reference.models.runtime_tracker import runtime_tracker_step
    out = dict(forward, queries=[forward["queries_last"]])
    with torch.no_grad(), no_tf32(), precision(fp8):
        st, _ = runtime_tracker_step(
            _ref_state(state_in), out, config["NUM_DET_QUERIES"],
            config["DET_SCORE_THRESH"], config["TRACK_SCORE_THRESH"],
            config["MISS_TOLERANCE"])
        st = apply_query_updater(ref.query_updater, st)
    return st


def written_from_state(st) -> Dict[int, Dict[str, np.ndarray]]:
    """The rows a writer gets for a state (as ``eval_frame_step``'s
    results): ids, labels, boxes, scores, mask, one dict a lane."""
    scores = torch.sigmoid(st.logits).amax(dim=-1)
    out = {}
    for lane in range(st.mask.shape[0]):
        out[lane] = {"ids": st.ids[lane].cpu().numpy(),
                     "labels": st.labels[lane].cpu().numpy(),
                     "boxes": st.boxes[lane].float().cpu().numpy(),
                     "scores": scores[lane].float().cpu().numpy(),
                     "mask": st.mask[lane].cpu().numpy()}
    return out


def compare_step(entry: Dict, written: Dict, ref_fwd: Dict, ref_st,
                 n_det: int) -> Dict[str, float]:
    """The five streaming numbers of one sampled step."""
    fwd = entry["forward"]
    live = entry["state_in"]["mask"]
    b = live.shape[0]
    rows = torch.cat([torch.ones((b, n_det), dtype=torch.bool,
                                 device=live.device), live], dim=1)
    out = {"logit_rms": _rms(fwd["pred_logits"], ref_fwd["pred_logits"],
                             rows),
           "box_rms": _rms(fwd["pred_boxes"], ref_fwd["pred_boxes"], rows)}
    prog = entry["state_out"]
    mismatch = 0
    for f in DISCRETE:
        a, r = prog[f], getattr(ref_st, f)
        mismatch += int((a != r.to(a.dtype)).sum())
    mismatch += int((prog["next_id"] != ref_st.next_id).sum())
    alive = ref_st.mask & prog["mask"]
    gap = 0.0
    for f in CONTINUOUS:
        gap = max(gap, _gap(prog[f], getattr(ref_st, f), alive))
    ref_rows = written_from_state(ref_st)
    rows_gap = 0.0
    for lane, rows_w in written.items():
        r = ref_rows[lane]
        mismatch += int((rows_w["mask"] != r["mask"]).sum())
        m = rows_w["mask"] & r["mask"]
        mismatch += int((rows_w["ids"][m] != r["ids"][m]).sum())
        mismatch += int((rows_w["labels"][m] != r["labels"][m]).sum())
        if m.any():
            rows_gap = max(rows_gap,
                           float(np.abs(rows_w["boxes"][m]
                                        - r["boxes"][m]).max()),
                           float(np.abs(rows_w["scores"][m]
                                        - r["scores"][m]).max()))
    out["state_gap"] = gap
    out["state_mismatch"] = float(mismatch)
    out["rows_gap"] = rows_gap
    return out


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def check_stream(run) -> Dict[str, float]:
    s, cfg = run.samples, run.config
    ref = reference_model(cfg, s["weights"], run.device)
    readings = []
    for k, entry in sorted(s["steps"].items()):
        written = s["written"].get(k)
        if written is None:
            raise RuntimeError(f"sampled step {k} was never written")
        ref_fwd = reference_forward(ref, entry, cfg["NUM_DET_QUERIES"])
        ref_st = reference_stage(ref, entry["state_in"], entry["forward"],
                                 cfg)
        readings.append(compare_step(entry, written, ref_fwd, ref_st,
                                     cfg["NUM_DET_QUERIES"]))
    return worst(readings)


def control_stream(run) -> Dict[str, float]:
    """The control: the reference in float8 in the program's place, on the
    same sampled inputs, judged as the program is."""
    s, cfg = run.samples, run.config
    ref = reference_model(cfg, s["weights"], run.device)
    readings = []
    n_det = cfg["NUM_DET_QUERIES"]
    for _, entry in sorted(s["steps"].items()):
        low_fwd = reference_forward(ref, entry, n_det, fp8=True)
        low_st = reference_stage(ref, entry["state_in"], low_fwd, cfg,
                                 fp8=True)
        low = dict(entry, forward=low_fwd,
                   state_out={f: getattr(low_st, f) for f in
                              DISCRETE + CONTINUOUS + ("next_id",)})
        ref_fwd = reference_forward(ref, entry, n_det)
        ref_st = reference_stage(ref, entry["state_in"], low_fwd, cfg)
        readings.append(compare_step(low, written_from_state(low_st),
                                     ref_fwd, ref_st, n_det))
    out = worst(readings)
    out["details"] = {
        "live_slots_in": [int(e["state_in"]["mask"].sum())
                          for _, e in sorted(s["steps"].items())],
        "live_slots_out": [int(e["state_out"]["mask"].sum())
                           for _, e in sorted(s["steps"].items())],
        "det_over_thresh": [int((torch.sigmoid(e["forward"]["pred_logits"][
            :, :n_det]).amax(-1) >= cfg["DET_SCORE_THRESH"]).sum())
            for _, e in sorted(s["steps"].items())]}
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is within its limit (a number over its
    limit, or one without a limit, is not correct)."""
    return all(k in limits and v <= limits[k] for k, v in readings.items())
