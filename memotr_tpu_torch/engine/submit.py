"""Streaming-inference submit engine (counterpart of
``memotr_tpu/engine/submit.py``).

Per sequence: upload each uint8 frame, normalize it on the device, run the
frame step (forward -> lifecycle -> query updater), fetch the slot results,
filter by score and area, and append MOT txt lines (or collect BDD100K
JSON).  Unless ``EVAL_CACHE`` is false, the frame step reads its
mask-dependent constants from an ``EvalCache``, which rebuilds them for any
frame whose padding mask differs from the cached one.

Two loops stream a sequence through the ``Submitter``:

- the **pipelined** loop (the default): a prefetch thread decodes frames and
  uploads them on a side CUDA stream; the main thread only dispatches frame
  steps and packs each frame's slot results into one ``(B, S, 9)`` float32
  tensor, copied without blocking into a pinned host buffer; a writer
  thread waits for that copy and writes the frame.  The main thread never
  waits for the device, so decode, upload, the device step and the fetch
  overlap.  On the CPU the same threads run with plain copies;
- the **sync** loop, frame by frame, which ``USE_MOTION`` and
  ``VISUALIZE`` need: motion reads each frame's track state on the host
  before the next step, and the debug dumps
  (``outputs/visualize/<seq>/frame_*.npz``, ``utils/debug_dump.py``) write
  each frame's results and track state.

``BatchedSubmitter`` streams B sequences of one canvas in lockstep through
the pipelined loop, one ``TrackState`` lane each; ``stream_sequences``
(behind ``submit(config)``) groups sequences by canvas for it when
``SUBMIT_BATCH`` > 1.  Frames are
dicts ``{"image": uint8 (H, W, 3), "mask": bool (H, W), "ori_hw", "path"}``
from any iterable (the ``Submitter``) or indexable sequence (the lanes), so
both run without an image decoder; ``submit(config)`` feeds them
``SeqDataset``.
"""
from __future__ import annotations

import json
import os
import queue as queue_mod
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import cfg_get, yaml_to_dict
from ..models.eval_cache import EvalCache
from ..models.frame_step import eval_frame_step
from ..models.memotr import build_model
from ..structures.track_state import TrackState
from ..utils.debug_dump import DebugDumper
from ..utils.misc import host_to_device

BDD_LABEL_NAMES = {
    0: "pedestrian", 1: "rider", 2: "car", 3: "truck", 4: "bus",
    5: "train", 6: "motorcycle", 7: "bicycle",
}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# bounded queues of the pipelined loop: frames uploaded ahead, and packed
# results on their way to the writer
PREFETCH_DEPTH = 2
RESULTS_DEPTH = 4
# pinned result buffers: one more than can be in flight (RESULTS_DEPTH
# queued, one being written, one being filled by the dispatch loop)
RESULT_RING = RESULTS_DEPTH + 2


def results_to_pixels(results: Dict, ori_hw, result_thresh: float,
                      area_thresh: float = 100.0, lane: int = 0):
    """Host-numpy slot results -> (keep indices, x1, y1, w, h, ids, labels)
    in original pixels.  Boxes are normalized to the valid (unpadded)
    region, so they scale by the original frame size directly."""
    ori_h, ori_w = ori_hw
    keep = results["mask"][lane] & (results["scores"][lane] > result_thresh)
    boxes = results["boxes"][lane]
    cx = boxes[:, 0] * ori_w
    cy = boxes[:, 1] * ori_h
    w = boxes[:, 2] * ori_w
    h = boxes[:, 3] * ori_h
    keep = keep & (w * h > area_thresh)
    return (np.nonzero(keep)[0], cx - w / 2, cy - h / 2, w, h,
            results["ids"][lane], results["labels"][lane])


def format_frame_results(i: int, results: Dict, ori_hw, path: str,
                         result_thresh: float, area_thresh: float,
                         dataset_name: str, lane: int = 0):
    """One frame's host-numpy results -> ``(bdd_frame_dict, None)`` for
    BDD100K or ``(None, txt_lines)`` for MOT txt."""
    keep_idx, x1, y1, w, h, ids, labels = results_to_pixels(
        results, ori_hw, result_thresh, area_thresh, lane=lane)
    if dataset_name == "BDD100K":
        img_name = os.path.basename(path)
        frame_result = {
            "name": img_name, "videoName": img_name[:-12],
            "frameIndex": i, "labels": []}
        for j in keep_idx:
            frame_result["labels"].append({
                "id": str(int(ids[j])),
                "category": BDD_LABEL_NAMES[int(labels[j])],
                "box2d": {"x1": float(x1[j]), "y1": float(y1[j]),
                          "x2": float(x1[j] + w[j]),
                          "y2": float(y1[j] + h[j])}})
        return frame_result, None
    return None, [f"{i + 1},{int(ids[j])},{x1[j]},{y1[j]},"
                  f"{w[j]},{h[j]},1,-1,-1,-1\n" for j in keep_idx]


def normalize_uint8(images: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization of raw uint8 frames, on their device (uint8
    uploads are 4x smaller than float32)."""
    mean = host_to_device(IMAGENET_MEAN, images.device, torch.float32)
    std = host_to_device(IMAGENET_STD, images.device, torch.float32)
    return (images.float() / 255.0 - mean) / std


def resolve_device(device: torch.device | str) -> torch.device:
    """The device an entry point runs on: a CUDA device unless the caller
    asks for the CPU, and an error when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU; pass "
                           "device='cpu' to run on the CPU")
    return device


def check_options(config: dict) -> None:
    """Raise on the options the port does not have: the TPU's in-process
    mesh over local devices (one process runs on one device)."""
    for key in ("MESH_DEVICES", "MESH_SEQ_DEVICES"):
        if cfg_get(config, key) not in (None, 1):
            raise NotImplementedError(
                f"{key}={config[key]}: the port runs one process per "
                f"device; for several, start one process a device with "
                f"`torchrun --nproc_per_node <n> -m memotr_tpu_torch.main "
                f"--multi-host` (ROADMAP.md, 'Do not port')")


# ------------------------------------------------------------ packed fetch
def pack_results(results: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Results dict -> one (B, S, 9) float32 tensor [id, label, cx, cy, w,
    h, score, alive, overflow], so the host makes one copy a frame; the
    lane's overflow count is repeated over its S rows.  Ids are exact in
    float32 below 2**24."""
    b, s = results["ids"].shape
    over = results["slot_overflow"].float()[:, None].expand(b, s)
    return torch.cat([
        results["ids"].float()[..., None],
        results["labels"].float()[..., None],
        results["boxes"].float(),
        results["scores"].float()[..., None],
        results["mask"].float()[..., None],
        over[..., None],
    ], dim=-1)


def unpack_results(arr: np.ndarray) -> Tuple[Dict[str, np.ndarray],
                                             np.ndarray]:
    """(B, S, 9) host array -> (results for ``format_frame_results``, the
    (B,) newborn-overflow counts)."""
    return {"ids": arr[..., 0].astype(np.int64),
            "labels": arr[..., 1].astype(np.int64),
            "boxes": arr[..., 2:6],
            "scores": arr[..., 6],
            "mask": arr[..., 7] > 0.5}, arr[:, 0, 8].astype(np.int64)


# ------------------------------------------------------- thread plumbing
class _PrefetchFailure:
    """Queue item carrying a worker thread's exception to the consumer, so
    a dead worker neither truncates the sequence nor leaves the consumer
    waiting forever."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _drain(q: "queue_mod.Queue"):
    """Yield queue items until the None end marker, raising a worker's
    failure in the consuming thread."""
    while True:
        item = q.get()
        if item is None:
            return
        if isinstance(item, _PrefetchFailure):
            raise item.exc
        yield item


def _put_until(q: "queue_mod.Queue", item, stop: Callable[[], bool]) -> bool:
    """Put ``item``, giving up (False) once ``stop()`` holds: a blocking
    put on a full queue whose reader has died would wait forever."""
    while not stop():
        try:
            q.put(item, timeout=0.2)
            return True
        except queue_mod.Full:
            continue
    return False


class _Aborted(Exception):
    """The consumer has stopped; the worker ends quietly."""


def _guarded(body: Callable[[Callable], None], q: "queue_mod.Queue",
             abort: threading.Event):
    """A worker thread's target: ``body(put)`` puts its items, then the
    end marker; any exception is put as a ``_PrefetchFailure``.  Every put
    gives up once ``abort`` is set."""
    def put(item):
        if not _put_until(q, item, abort.is_set):
            raise _Aborted

    def worker():
        try:
            body(put)
            put(None)
        except _Aborted:
            pass
        except BaseException as e:      # noqa: BLE001 - re-raised by _drain
            _put_until(q, _PrefetchFailure(e), abort.is_set)
    return worker


def _prefetch(items: Iterable, abort: threading.Event,
              prepare: Optional[Callable] = None):
    """Iterate ``items`` (each passed through ``prepare``) in a thread,
    PREFETCH_DEPTH ahead of the consumer."""
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=PREFETCH_DEPTH)

    def body(put):
        for item in items:
            put(prepare(item) if prepare is not None else item)

    threading.Thread(target=_guarded(body, q, abort), daemon=True).start()
    return _drain(q)


def stream_pipelined(batches: Iterable[Tuple[np.ndarray, np.ndarray, object]],
                     step: Callable, write: Callable, device: torch.device
                     ) -> List[float]:
    """The pipelined loop.  ``batches`` yields ``(images (B, H, W, 3)
    uint8, masks (B, H, W) bool, meta)`` and is read in a prefetch thread,
    which uploads each batch (on CUDA: pinned, ``non_blocking`` on a side
    stream, then an event).  ``step(images, masks, host_masks)`` runs in
    the calling thread and returns the packed (B, S, 9) results on the
    device.  ``write(i, packed host array, meta)`` runs in a writer thread.
    Returns each batch's completion time (``time.perf_counter``) in the
    writer.  An exception in any of the three threads is raised here."""
    cuda = device.type == "cuda"
    abort = threading.Event()
    errs: List[BaseException] = []
    done_at: List[float] = []
    results_q: "queue_mod.Queue" = queue_mod.Queue(maxsize=RESULTS_DEPTH)
    side = torch.cuda.Stream(device) if cuda else None

    def upload(batch):
        images, masks, meta = batch
        img = torch.from_numpy(np.ascontiguousarray(images))
        msk = torch.from_numpy(np.ascontiguousarray(masks))
        if not cuda:
            return img, msk, masks, None, meta
        with torch.cuda.device(device), torch.cuda.stream(side):
            img = img.pin_memory().to(device, non_blocking=True)
            msk = msk.pin_memory().to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        return img, msk, masks, ready, meta

    def writer():
        try:
            while True:
                try:
                    got = results_q.get(timeout=0.2)
                except queue_mod.Empty:
                    if abort.is_set():
                        return
                    continue
                if got is None:
                    return
                i, packed, copied, meta = got
                if copied is not None:
                    copied.synchronize()
                write(i, packed.numpy().copy(), meta)
                done_at.append(time.perf_counter())
        except BaseException as e:      # noqa: BLE001 - raised below
            errs.append(e)

    def writer_dead() -> bool:
        return bool(errs) or not wt.is_alive()

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    ring: List[torch.Tensor] = []
    try:
        compute = torch.cuda.current_stream(device) if cuda else None
        for i, (img, msk, host_masks, ready, meta) in enumerate(
                _prefetch(batches, abort, prepare=upload)):
            if cuda:
                compute.wait_event(ready)
                img.record_stream(compute)
                msk.record_stream(compute)
            packed = step(img, msk, host_masks)
            copied = None
            if cuda:
                if not ring:
                    ring = [torch.empty(packed.shape, dtype=torch.float32,
                                        pin_memory=True)
                            for _ in range(RESULT_RING)]
                buf = ring[i % RESULT_RING]
                buf.copy_(packed, non_blocking=True)
                packed = buf
                # the writer sleeps on it rather than spin
                copied = torch.cuda.Event(blocking=True)
                copied.record(compute)
            if not _put_until(results_q, (i, packed, copied, meta),
                              writer_dead):
                break
        _put_until(results_q, None, writer_dead)
        wt.join()
    finally:
        abort.set()
    if errs:
        raise errs[0]
    return done_at


# -------------------------------------------------------------- Submitter
class _Streamer:
    """What both submitters share: the device, the model with its eval
    cache and thresholds, the output directory and the frame step."""

    def __init__(self, dataset_name: str, outputs_dir: str, model,
                 config: dict, device: torch.device | str):
        check_options(config)
        self.device = resolve_device(device)
        self.dataset_name = dataset_name
        self.predict_dir = os.path.join(outputs_dir, "tracker")
        os.makedirs(self.predict_dir, exist_ok=True)
        self.model = model
        self.eval_cache = EvalCache(model, self.device) \
            if cfg_get(config, "EVAL_CACHE") else None
        self.det_thresh = config["DET_SCORE_THRESH"]
        self.track_thresh = config["TRACK_SCORE_THRESH"]
        self.result_thresh = config["RESULT_SCORE_THRESH"]
        self.miss_tolerance = config["MISS_TOLERANCE"]
        self.track_slots = cfg_get(config, "TRACK_SLOTS")
        self.area_thresh = 100
        self.frame_seconds: List[float] = []

    def _empty_state(self, batch: int) -> TrackState:
        m = self.model
        return TrackState.empty(batch, self.track_slots, m.hidden_dim,
                                m.num_classes, use_dab=m.use_dab,
                                device=self.device)

    def _step(self, images: torch.Tensor, mask: torch.Tensor,
              host_mask: np.ndarray, state: TrackState):
        """Normalize on the device and run the frame step, with the eval
        cache's constants for ``host_mask``."""
        ctx = self.eval_cache.lookup(host_mask) \
            if self.eval_cache is not None else None
        return eval_frame_step(
            self.model, normalize_uint8(images), mask, state,
            self.det_thresh, self.track_thresh, self.miss_tolerance, ctx)


class Submitter(_Streamer):
    """Streams one sequence through the model and writes its results.

    ``frames`` is any iterable of frame dicts (see the module docstring).
    ``pipelined`` (the default, False with ``USE_MOTION`` or
    ``VISUALIZE``) picks the loop.
    After ``run``, ``frame_seconds`` holds each frame's host seconds: in
    the sync loop from upload to fetched results, in the pipelined loop
    from the previous frame's completion in the writer (the first frame's
    from the loop's start) to its own."""

    def __init__(self, dataset_name: str, frames: Iterable[Dict],
                 seq_name: str, outputs_dir: str, model, config: dict,
                 device: torch.device | str = "cuda"):
        super().__init__(dataset_name, outputs_dir, model, config, device)
        self.frames = frames
        self.seq_name = seq_name
        self.use_motion = bool(cfg_get(config, "USE_MOTION"))
        self.motion_lambda = cfg_get(config, "MOTION_LAMBDA")
        if self.use_motion:
            from ..models.motion import MotionBank
            self.motion_bank = MotionBank(cfg_get(config, "MOTION_MIN_LENGTH"),
                                          cfg_get(config, "MOTION_MAX_LENGTH"))
            self._prev_disappear: Dict[int, int] = {}
        visualize = bool(cfg_get(config, "VISUALIZE"))
        self.dumper = DebugDumper(
            os.path.join(outputs_dir, "visualize", seq_name), visualize)
        # motion and the dumps read every frame's track state on the host
        self.pipelined = not (self.use_motion or visualize)
        txt = os.path.join(self.predict_dir, f"{seq_name}.txt")
        if os.path.exists(txt):
            os.remove(txt)

    def _write_frame(self, i: int, results: Dict, ori_hw, path: str,
                     bdd_results: List[Dict]):
        bdd_frame, txt_lines = format_frame_results(
            i, results, ori_hw, path, self.result_thresh, self.area_thresh,
            self.dataset_name)
        if bdd_frame is not None:
            bdd_results.append(bdd_frame)
        else:
            with open(os.path.join(self.predict_dir,
                                   f"{self.seq_name}.txt"), "a") as f:
                f.write("".join(txt_lines))

    def _finish(self, bdd_results: List[Dict], overflow_total: int):
        if self.dataset_name == "BDD100K":
            with open(os.path.join(self.predict_dir,
                                   f"{self.seq_name}.json"), "w") as f:
                json.dump(bdd_results, f)
        if overflow_total:
            print(f"[submit {self.seq_name}] WARNING: {overflow_total} "
                  f"newborn tracks dropped (all {self.track_slots} slots "
                  f"full) - raise TRACK_SLOTS", flush=True)

    @torch.inference_mode()
    def run(self) -> float:
        """Streams the sequence.  Returns the pipelined loop's wall time,
        or the sync loop's summed per-frame seconds."""
        return self._run_pipelined() if self.pipelined else self._run_sync()

    def _run_sync(self) -> float:
        state = self._empty_state(1)
        bdd_results: List[Dict] = []
        overflow_total = 0
        self.frame_seconds = []
        abort = threading.Event()
        try:
            for i, item in enumerate(_prefetch(self.frames, abort)):
                t0 = time.perf_counter()
                images = torch.from_numpy(
                    np.ascontiguousarray(item["image"]))[None]
                mask = np.ascontiguousarray(item["mask"])[None]
                results, state = self._step(
                    images.to(self.device),
                    torch.from_numpy(mask).to(self.device), mask, state)
                results = {k: v.cpu().numpy() for k, v in results.items()}
                self.frame_seconds.append(time.perf_counter() - t0)
                overflow_total += int(results.pop("slot_overflow").sum())
                self.dumper.dump_frame(i, results=results, state=state)
                if self.use_motion:
                    state = self._apply_motion(state)
                self._write_frame(i, results, item["ori_hw"], item["path"],
                                  bdd_results)
        finally:
            abort.set()
        self._finish(bdd_results, overflow_total)
        return sum(self.frame_seconds)

    def _run_pipelined(self) -> float:
        state = self._empty_state(1)
        bdd_results: List[Dict] = []
        overflow = [0]

        def batches():
            for item in self.frames:
                yield (item["image"][None], item["mask"][None],
                       (item["ori_hw"], item["path"]))

        def step(images, mask, host_mask):
            nonlocal state
            results, state = self._step(images, mask, host_mask, state)
            return pack_results(results)

        def write(i, arr, meta):
            results, over = unpack_results(arr)
            overflow[0] += int(over[0])
            self._write_frame(i, results, *meta, bdd_results)

        t0 = time.perf_counter()
        done_at = stream_pipelined(batches(), step, write, self.device)
        wall = time.perf_counter() - t0
        self.frame_seconds = list(np.diff([t0] + done_at))
        self._finish(bdd_results, overflow[0])
        return wall

    def _apply_motion(self, state: TrackState) -> TrackState:
        """Post-hoc motion of disappeared tracks' reference points: a
        track's record restarts when it is seen again after missing frames;
        a missing track with a long enough record gets the logit of its
        extrapolated box (clipped to [1e-5, 1 - 1e-5]) as ``ref_pts``."""
        from scipy.special import logit
        mask = state.mask[0].cpu().numpy()
        ids = state.ids[0].cpu().numpy()
        boxes = state.boxes[0].cpu().numpy()
        last_appear = state.last_appear_boxes[0].cpu().numpy()
        disappear = state.disappear_time[0].cpu().numpy()
        new_ref = None
        for s in np.nonzero(mask)[0]:
            if disappear[s] == 0:
                reappeared = self._prev_disappear.get(int(ids[s]), 0) > 0
                self.motion_bank.observe(ids[s], boxes[s],
                                         reappeared=reappeared)
            elif disappear[s] > 0:
                extra = self.motion_bank.extrapolate(
                    ids[s], last_appear[s], int(disappear[s]),
                    self.motion_lambda)
                if extra is not None:
                    if new_ref is None:
                        new_ref = state.ref_pts[0].cpu().numpy().copy()
                    new_ref[s] = logit(np.clip(extra, 1e-5, 1 - 1e-5))
        for s in np.nonzero(mask)[0]:
            self._prev_disappear[int(ids[s])] = int(disappear[s])
        if new_ref is not None:
            ref_pts = state.ref_pts.clone()
            ref_pts[0] = torch.from_numpy(new_ref).to(ref_pts.device)
            state = state.replace(ref_pts=ref_pts)
        return state


class BatchedSubmitter(_Streamer):
    """Lockstep streaming of B sequences of one canvas on one device, one
    ``TrackState`` lane each, through the pipelined loop.  Every op of the
    frame step is batch-pointwise, so each lane tracks its sequence as the
    B=1 ``Submitter`` does.  A lane whose sequence has ended replays its
    last frame (shapes stay fixed, its mask stays valid) and its output is
    dropped; overflow is counted over the active lanes; each lane's txt
    (or BDD json) is written at the end.

    ``sequences``: one indexable sequence of frame dicts a lane (a
    ``SeqDataset``, or a list)."""

    def __init__(self, dataset_name: str, sequences: Sequence[Sequence[Dict]],
                 seq_names: Sequence[str], outputs_dir: str, model,
                 config: dict, device: torch.device | str = "cuda"):
        for key in ("USE_MOTION", "VISUALIZE"):
            if cfg_get(config, key):
                raise ValueError(f"{key} needs the sequential Submitter; "
                                 "submit() falls back to SUBMIT_BATCH 1 for "
                                 "it")
        assert len(sequences) == len(seq_names) and len(sequences) > 0
        super().__init__(dataset_name, outputs_dir, model, config, device)
        self.sequences = list(sequences)
        self.seq_names = list(seq_names)
        self.lens = [len(seq) for seq in self.sequences]
        canvases = {np.shape(seq[0]["mask"]) for seq in self.sequences}
        assert len(canvases) == 1, \
            f"batch lanes must share a canvas, got {canvases}"

    @torch.inference_mode()
    def run(self) -> Tuple[float, int]:
        """Returns (the loop's wall seconds, frames streamed over all
        lanes)."""
        b, lens = len(self.sequences), self.lens
        state = self._empty_state(b)
        txt_lines: List[List[str]] = [[] for _ in range(b)]
        bdd_results: List[List[Dict]] = [[] for _ in range(b)]
        overflow = [0]

        def batches():
            for i in range(max(lens)):
                items = [seq[min(i, n - 1)]
                         for seq, n in zip(self.sequences, lens)]
                yield (np.stack([it["image"] for it in items]),
                       np.stack([it["mask"] for it in items]),
                       [(it["ori_hw"], it["path"]) for it in items])

        def step(images, masks, host_masks):
            nonlocal state
            results, state = self._step(images, masks, host_masks, state)
            return pack_results(results)

        def write(i, arr, meta):
            results, over = unpack_results(arr)
            active = np.asarray([i < n for n in lens])
            overflow[0] += int(over[active].sum())
            for lane in np.nonzero(active)[0]:
                ori_hw, path = meta[lane]
                bdd_frame, lines = format_frame_results(
                    i, results, ori_hw, path, self.result_thresh,
                    self.area_thresh, self.dataset_name, lane=lane)
                if bdd_frame is not None:
                    bdd_results[lane].append(bdd_frame)
                else:
                    txt_lines[lane].extend(lines)

        t0 = time.perf_counter()
        done_at = stream_pipelined(batches(), step, write, self.device)
        wall = time.perf_counter() - t0
        self.frame_seconds = list(np.diff([t0] + done_at))
        for lane, name in enumerate(self.seq_names):
            if self.dataset_name == "BDD100K":
                with open(os.path.join(self.predict_dir,
                                       f"{name}.json"), "w") as f:
                    json.dump(bdd_results[lane], f)
            else:
                with open(os.path.join(self.predict_dir,
                                       f"{name}.txt"), "w") as f:
                    f.write("".join(txt_lines[lane]))
        if overflow[0]:
            print(f"[submit batch {self.seq_names}] WARNING: {overflow[0]} "
                  f"newborn tracks dropped (all {self.track_slots} slots "
                  f"full) - raise TRACK_SLOTS", flush=True)
        return wall, sum(lens)


# ------------------------------------------------------------------ entry
def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A reference-format checkpoint: ``{"model": state_dict}`` or a bare
    state dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt["model"] if "model" in ckpt else ckpt


def decode_note(native: bool) -> str:
    """Which decode path a dataset takes, for the logs."""
    from ..data import native as dataplane
    if native:
        return "native data plane (native/dataplane.cpp)"
    return (f"python (cv2); native data plane unavailable: "
            f"{dataplane.unavailable_reason()}")


def submit(config: dict, device: torch.device | str = "cuda"):
    """Submit entry: every sequence of the split, through
    ``stream_sequences``; in a process group, this rank's share of the
    sorted sequences (``names[rank::world]``, as the JAX package shards
    them over hosts), in either of its branches.

    Reads ``SUBMIT_DIR/train/config.yaml`` for the model and loads the
    reference-format ``.pth`` at ``SUBMIT_DIR/SUBMIT_MODEL``.  Runs on the
    GPU unless ``device="cpu"``."""
    from ..data.seq_dataset import SeqDataset
    from ..utils.distributed import rank_and_world
    check_options(config)
    device = resolve_device(device)
    train_config = yaml_to_dict(
        os.path.join(config["SUBMIT_DIR"], "train/config.yaml"))
    dataset_name = train_config["DATASET"]
    config = dict(config, DATASET=dataset_name)
    for key in ("HIDDEN_DIM", "TRACK_SLOTS", "USE_DAB"):
        if key in train_config:
            config.setdefault(key, train_config[key])

    model = build_model(train_config)
    model.load_state_dict(load_state_dict_file(
        os.path.join(config["SUBMIT_DIR"], config["SUBMIT_MODEL"])))
    model.to(device).eval()

    split = config["SUBMIT_DATA_SPLIT"]
    root = config["DATA_ROOT"]
    if dataset_name in ("DanceTrack", "SportsMOT"):
        split_dir = os.path.join(root, dataset_name, split)
    elif dataset_name == "BDD100K":
        split_dir = os.path.join(root, dataset_name, "images/track/", split)
    else:
        split_dir = os.path.join(root, dataset_name, "images", split)
    rank, world = rank_and_world()
    sequences = [(seq, SeqDataset(os.path.join(split_dir, seq),
                                  cfg_get(config, "EVAL_SHORT_SIDE"),
                                  cfg_get(config, "EVAL_MAX_SIDE")))
                 for seq in sorted(os.listdir(split_dir))[rank::world]]
    if not sequences:
        print(f"Rank {rank} of {world}: no sequence to submit", flush=True)
        return
    print(f"Frame decode: {decode_note(sequences[0][1].native)}", flush=True)
    stream_sequences(dataset_name, sequences,
                     os.path.join(config["SUBMIT_DIR"], split), model, config,
                     device)


def stream_sequences(dataset_name: str, sequences: Sequence[Tuple[str, Sequence]],
                     outputs_dir: str, model, config: dict,
                     device: torch.device | str = "cuda"):
    """Streams ``(name, sequence)`` pairs, each sequence indexable with a
    ``padded_canvas()`` (``SeqDataset``).  With ``SUBMIT_BATCH`` > 1 they
    are grouped by canvas and streamed that many at a time through
    ``BatchedSubmitter``; otherwise, and always with ``USE_MOTION`` or
    ``VISUALIZE``, one ``Submitter`` each."""
    batch = int(cfg_get(config, "SUBMIT_BATCH"))
    if batch > 1 and (cfg_get(config, "USE_MOTION")
                      or cfg_get(config, "VISUALIZE")):
        print("SUBMIT_BATCH ignored: VISUALIZE/USE_MOTION force the "
              "sequential submit path", flush=True)
        batch = 1
    if batch == 1:
        for name, seq in sequences:
            print(f"Submitting {name}", flush=True)
            Submitter(dataset_name, (seq[i] for i in range(len(seq))), name,
                      outputs_dir, model, config, device).run()
        return
    groups: Dict[tuple, List[tuple]] = {}
    for name, seq in sequences:
        groups.setdefault(tuple(seq.padded_canvas()), []).append((name, seq))
    for canvas, members in groups.items():
        for i in range(0, len(members), batch):
            chunk = members[i:i + batch]
            names = [name for name, _ in chunk]
            print(f"Submitting batch {names} (canvas {canvas})", flush=True)
            BatchedSubmitter(dataset_name, [seq for _, seq in chunk], names,
                             outputs_dir, model, config, device).run()
