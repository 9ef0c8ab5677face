"""Faults planted in the program underneath a run, for the test that sees
``correct`` come out false and for reading a fault's numbers on the card
(``control.py --fault``).  Each fault patches the program through
``patch(owner, name, value)`` (pytest's ``monkeypatch.setattr``, or
``Patches``, which undoes them).  The cells run on one chip, so no fault
leaves out an exchange between chips.

The faults below can touch every configuration.  A fault of one part of
the model sits in a file of its own, ``benchmark/planted/<fault>.py``,
with ``plant(patch)`` and ``ENCODERS``, the ``ENCODER_TYPE`` values whose
models it reaches; ``FAULTS`` holds both kinds, and ``applies`` says
whether a fault can touch a configuration."""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Callable, Dict, List, Tuple

PLANTED = Path(__file__).resolve().parent / "planted"


class Patches:
    """``setattr`` that remembers what it replaced, undone by ``undo``."""

    def __init__(self):
        self.saved: List[Tuple[object, str, object]] = []

    def __call__(self, owner, name, value):
        self.saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        while self.saved:
            owner, name, value = self.saved.pop()
            setattr(owner, name, value)


# ------------------------------------------------------------- streaming
def state_unchanged(patch) -> None:
    """The frame step returns the state it was given."""
    from memotr_tpu_torch.engine import submit
    orig = submit.eval_frame_step

    def step(model, images, mask, state, *a, **k):
        results, _ = orig(model, images, mask, state, *a, **k)
        return results, state
    patch(submit, "eval_frame_step", step)


def half_lanes(patch) -> None:
    """The model computes the first half of the lanes and repeats them in
    the others."""
    from memotr_tpu_torch.models import memotr
    orig = memotr.MeMOTR.forward

    def forward(self, images, img_mask, q, ref, tmask, eval_ctx=None):
        b = images.shape[0]
        h = max(1, b // 2)
        out = orig(self, images[:h], img_mask[:h], q[:h], ref[:h], tmask[:h])

        def tile(t, dim):
            reps = [1] * t.dim()
            reps[dim] = -(-b // h)
            return t.repeat(*reps).narrow(dim, 0, b)
        return {k: (tile(v, 1) if k in ("all_logits", "all_boxes", "queries")
                    else v if k == "det_query_embed" else tile(v, 0))
                for k, v in out.items()}
    patch(memotr.MeMOTR, "forward", forward)


def answer_altered(patch) -> None:
    """Every box's x centre moves by 0.05 where the results are packed."""
    from memotr_tpu_torch.engine import submit
    orig = submit.pack_results

    def pack(results):
        packed = orig(results).clone()
        packed[..., 2] += 0.05
        return packed
    patch(submit, "pack_results", pack)


def _planted() -> Dict[str, Tuple[Callable, Tuple[str, ...]]]:
    out = {}
    for path in sorted(PLANTED.glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            f"benchmark.planted.{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = (mod.plant, tuple(mod.ENCODERS))
    return out


_FILES = _planted()
FAULTS: Dict[str, Callable] = {
    **{f.__name__: f for f in (state_unchanged, half_lanes, answer_altered)},
    **{name: plant for name, (plant, _) in _FILES.items()}}
# the encoder types each planted fault reaches; the others reach every one
ENCODERS: Dict[str, Tuple[str, ...]] = {
    name: kinds for name, (_, kinds) in _FILES.items()}


def applies(fault: str, config: dict) -> bool:
    """Whether ``fault`` can touch the model of ``config``."""
    return fault not in ENCODERS or (
        config.get("ENCODER_TYPE") or "deformable") in ENCODERS[fault]
