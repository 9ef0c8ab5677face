"""The port's own spans (``memotr_tpu_torch/utils/profiling.py: span``) on
the CPU, at a tiny deformable model (C = 32, 12 detection queries, 8
slots, 1 encoder and 2 decoder layers, float32, random weights):

- with no profiler, ``span`` returns one shared null context, opens no
  ``record_function`` and costs under a microsecond a call;
- under ``profiling.trace``, a ``BatchedSubmitter`` run (B = 2, 4 frames)
  records every span of the streaming path, each on its own thread
  (prefetch, dispatch, writer);
- ``model.encoder`` nests in ``submit.step``, and K1's op
  (``memotr_tpu_torch::msda_fwd``, which the CPU runs plainly under
  ``inference_mode``) nests in ``model.encoder``;
- the k-th ``submit.upload`` ends before the k-th ``submit.step`` starts,
  and that step ends before the k-th ``submit.write`` starts;
- a serving export (``serving.export_streaming``) made while the profiler
  records opens no range and holds no profiler node.
"""
import timeit
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from memotr_tpu_torch.engine.submit import BatchedSubmitter
from memotr_tpu_torch.models.memotr import build_model
from memotr_tpu_torch.utils import profiling

CONFIG = {
    "DATASET": "DanceTrack", "HIDDEN_DIM": 32, "FFN_DIM": 64,
    "NUM_FEATURE_LEVELS": 4, "NUM_HEADS": 8, "NUM_ENC_POINTS": 4,
    "NUM_DEC_POINTS": 4, "NUM_ENC_LAYERS": 1, "NUM_DEC_LAYERS": 2,
    "NUM_DET_QUERIES": 12, "TRACK_SLOTS": 8, "DTYPE": "float32",
    "DET_SCORE_THRESH": 0.5, "TRACK_SCORE_THRESH": 0.5,
    "RESULT_SCORE_THRESH": 0.5, "MISS_TOLERANCE": 30,
}
HW = (64, 96)
LANES, N_FRAMES = 2, 4
PREFETCH = ("submit.prepare", "submit.upload")
DISPATCH = ("submit.wait_input", "submit.step", "submit.copy_out",
            "submit.wait_writer", "step.eval_cache", "step.eval_cache_build",
            "step.normalize", "model.backbone", "model.neck",
            "model.encoder", "model.decoder", "step.tracker", "step.updater",
            "step.pack")
WRITER = ("submit.wait_device", "submit.write")
K1 = "memotr_tpu_torch::msda_fwd"


@pytest.fixture(scope="module")
def model():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.manual_seed(0)
    yield build_model(CONFIG).eval()
    torch.set_num_threads(n)


def _lane(seed):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 255, HW + (3,), np.uint8),
             "mask": np.zeros(HW, bool), "ori_hw": HW,
             "path": f"{t:08d}.jpg"} for t in range(N_FRAMES)]


@pytest.fixture(scope="module")
def events(model, tmp_path_factory):
    """(name, start ns, end ns, thread) of every span and K1 op of one
    profiled ``BatchedSubmitter`` run."""
    out = tmp_path_factory.mktemp("spans")
    sub = BatchedSubmitter("DanceTrack", [_lane(i) for i in range(LANES)],
                           [f"lane{i}" for i in range(LANES)], str(out),
                           model, CONFIG, "cpu")
    with profiling.trace(str(out / "trace")) as prof:
        sub.run()
    names = set(PREFETCH + DISPATCH + WRITER + (K1,))
    return sorted((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                   e.start_thread_id())
                  for e in prof.profiler.kineto_results.events()
                  if e.name() in names)


def _named(events, name):
    return [e for e in events if e[0] == name]


def test_span_off_is_a_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range opened for {name!r}")
    monkeypatch.setattr(profiling, "record_function", refuse)
    a, b = profiling.span("model.backbone"), profiling.span("submit.step")
    assert a is b
    with a:
        pass


def test_span_off_costs_under_a_microsecond():
    def call():
        with profiling.span("model.encoder"):
            pass
    n = 100_000
    best = min(timeit.repeat(call, number=n, repeat=7)) / n
    assert best < 1e-6, f"{best * 1e6:.3f} us a call"


def test_every_span_is_recorded_on_its_own_thread(events):
    threads = []
    for group in (PREFETCH, DISPATCH, WRITER):
        tids = set()
        for name in group:
            got = _named(events, name)
            expected = 1 if name == "step.eval_cache_build" else N_FRAMES
            if name in ("submit.prepare", "submit.wait_input"):
                expected = N_FRAMES + 1         # the last reads the end
            assert len(got) == expected, (name, len(got))
            tids |= {e[3] for e in got}
        assert len(tids) == 1, (group, tids)
        threads.append(tids.pop())
    assert len(set(threads)) == 3


def test_encoder_nests_in_the_step_and_k1_in_the_encoder(events):
    def inside(inner, outers):
        return any(o[3] == inner[3] and o[1] <= inner[1] and inner[2] <= o[2]
                   for o in outers)
    steps, encoders = _named(events, "submit.step"), \
        _named(events, "model.encoder")
    assert encoders and all(inside(e, steps) for e in encoders)
    k1 = _named(events, K1)
    assert len(k1) == N_FRAMES * (CONFIG["NUM_ENC_LAYERS"]
                                  + CONFIG["NUM_DEC_LAYERS"])
    in_encoder = [e for e in k1 if inside(e, encoders)]
    assert len(in_encoder) == N_FRAMES * CONFIG["NUM_ENC_LAYERS"]
    assert all(inside(e, _named(events, "model.decoder"))
               for e in k1 if e not in in_encoder)


def test_kth_upload_step_and_write_follow_in_order(events):
    def by_start(name):
        return sorted(_named(events, name), key=lambda e: e[1])
    uploads, steps, writes = (by_start(n) for n in
                              ("submit.upload", "submit.step",
                               "submit.write"))
    for up, st, wr in zip(uploads, steps, writes, strict=True):
        assert up[2] <= st[1] and st[2] <= wr[1]


def test_export_under_the_profiler_holds_no_profiler_node(model, tmp_path,
                                                         monkeypatch):
    from memotr_tpu_torch.serving import export_streaming
    opened = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: opened.append(name) or nullcontext())
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        export_streaming(CONFIG, model.state_dict(), str(tmp_path),
                         canvas_hw=HW, batch=1, device="cpu")
    assert opened == []
    program = torch.export.load(str(tmp_path / "step.pt2"))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert any("msda_fwd" in t for t in targets)
    assert not [t for t in targets if "profiler" in t or "record" in t]
