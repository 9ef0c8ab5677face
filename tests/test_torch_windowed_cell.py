"""The windowed flagship as the benchmark streams it (cell
``windowed_stream_b24``, configuration
``benchmark/configs/memotr_windowed_dancetrack.json``), on the CPU in
float32 with seeded weights, at the benchmark tests' small widths
(``benchmark/tests/conftest.py: TINY_CONFIG``) and the flagship's three
encoder layers (window, grid, window) and options:

- the port's ``WindowedEncoder`` against the benchmark's plain reference
  part (``benchmark/reference/models/encoders/windowed.py``, which
  partitions the map for grid attention directly where the port
  block-transposes it), with padded columns in one lane, at level sizes
  that are and are not multiples of the window;
- the port's whole streaming frame step (eval cache, normalization,
  model, runtime tracker, query updater) against the reference's, two
  frames of two lanes, each side carrying its own track state;
- the windowed layer's spans in a profiled forward: per layer and level
  ``encoder.lepe``, ``encoder.attn`` (holding K2's op) and
  ``encoder.ffn``, then ``encoder.fuse``, in that order, inside
  ``model.encoder``;
- the configuration file holding the yaml's keys as run.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import gen, reference  # noqa: E402
from benchmark.reference.models import encoders  # noqa: E402
from benchmark.reference.models.frame_step import \
    eval_frame_step as ref_frame_step  # noqa: E402
from benchmark.reference.structures.track_state import \
    TrackState as RefState  # noqa: E402
from benchmark.tests.conftest import TINY_CONFIG  # noqa: E402
from memotr_tpu_torch.config import _DEFAULTS  # noqa: E402
from memotr_tpu_torch.engine.submit import normalize_uint8  # noqa: E402
from memotr_tpu_torch.models.eval_cache import EvalCache  # noqa: E402
from memotr_tpu_torch.models.frame_step import eval_frame_step  # noqa: E402
from memotr_tpu_torch.models.memotr import build_model  # noqa: E402
from memotr_tpu_torch.structures.track_state import TrackState  # noqa: E402

CONFIG_FILE = ROOT / "benchmark" / "configs" / "memotr_windowed_dancetrack.json"
YAML = ROOT / "configs" / "train_dancetrack_windowed.yaml"
SEED = 3_000_000_019
K2 = "memotr_tpu_torch::window_attn_fwd"
SPANS = ("encoder.lepe", "encoder.attn", "encoder.ffn")


def _config():
    cfg = json.loads(CONFIG_FILE.read_text())["config"]
    return dict(cfg, **dict(TINY_CONFIG, NUM_ENC_LAYERS=cfg["NUM_ENC_LAYERS"]))


@pytest.fixture(scope="module")
def program():
    """The port's model at the small widths, with the benchmark's seeded
    weights, and those weights; one CPU thread while the file runs (the
    suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = _config()
    torch.manual_seed(0)
    model = build_model(cfg).eval()
    weights = gen.make_weights(model, SEED, "cpu")
    model.load_state_dict(weights)
    yield model, weights
    torch.set_num_threads(n)


def test_config_file_holds_the_yamls_keys_as_run():
    f = json.loads(CONFIG_FILE.read_text())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"]
                 if c["name"] == "memotr_windowed_dancetrack")
    assert entry["file"] == str(CONFIG_FILE.relative_to(ROOT))
    assert f["reduced"] == entry["reduced"] == []
    assert f["source"] == entry["source"]
    cfg, published = f["config"], yaml.safe_load(YAML.read_text())
    assert {k: cfg[k] for k in published} == published
    # the one option the yaml leaves to the port's defaults
    assert set(cfg) - set(published) == {"WINDOWED_SHARED_CPB"}
    assert cfg["WINDOWED_SHARED_CPB"] is _DEFAULTS["WINDOWED_SHARED_CPB"]
    assert (cfg["ENCODER_TYPE"], cfg["NUM_ENC_LAYERS"],
            cfg["WINDOW_SIZE"]) == ("windowed", 3, 8)


@pytest.mark.parametrize("shapes", [
    ((16, 24), (8, 12), (4, 6), (2, 3)),      # level 0 a window multiple
    ((13, 22), (7, 11), (4, 6), (2, 3)),      # no level a window multiple
])
def test_encoder_matches_the_reference_part(program, shapes):
    model, weights = program
    cfg = _config()
    part = encoders.build(cfg, torch.float32)
    prefix = "transformer.encoder."
    part.load_state_dict({k[len(prefix):]: v for k, v in weights.items()
                          if k.startswith(prefix)})
    g = torch.Generator().manual_seed(7)
    s, c = sum(h * w for h, w in shapes), cfg["HIDDEN_DIM"]
    src, pos = torch.randn(2, 2, s, c, generator=g)
    masks = []
    for h, w in shapes:
        m = torch.zeros(2, h, w, dtype=torch.bool)
        m[1, :, w - w // 3:] = True
        masks.append(m.flatten(1))
    mask = torch.cat(masks, dim=1)
    ratios = torch.ones(2, len(shapes), 2)
    with torch.no_grad():
        a = model.transformer.encoder(src, shapes, ratios, pos, mask)
        b = part(src, shapes, ratios, pos, mask)
    assert a.shape == b.shape == (2, s, c)
    assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_frame_step_matches_the_reference(program):
    """A canvas the frame fills (64x96: levels 8x12, 4x6, 2x3, 1x2, none
    but the first a window multiple), so the eval cache's numpy position
    maps equal the reference's torch ones to rounding; class heads
    calibrated to 5 detections on lane 0's first frame, which the second
    frame carries as live tracks."""
    model, weights = program
    cfg = _config()
    frames = gen.stream_lanes(SEED, "cpu", 2, 2, (64, 96), (64, 96), 64,
                              96, 3, (0.1, 0.3), (0.2, 0.5), 6.0)
    weights = {k: v.clone() for k, v in weights.items()}
    gen.calibrate_detections(weights, cfg, frames["images"][0, 0],
                             frames["mask"], 5, "cpu")
    model = build_model(cfg).eval()
    model.load_state_dict(weights)
    ref = reference.build(cfg).eval()
    ref.load_state_dict(weights)
    host_mask = np.broadcast_to(frames["mask"], (2,) + frames["mask"].shape)
    mask = torch.as_tensor(host_mask.copy())
    cache = EvalCache(model, "cpu")
    n, c = cfg["TRACK_SLOTS"], cfg["HIDDEN_DIM"]
    st = TrackState.empty(2, n, c, model.num_classes)
    rst = RefState.empty(2, n, c, ref.num_classes)
    thresholds = (cfg["DET_SCORE_THRESH"], cfg["TRACK_SCORE_THRESH"],
                  cfg["MISS_TOLERANCE"])
    live = 0
    with torch.no_grad():
        for t in range(2):
            images = torch.as_tensor(frames["images"][:, t])
            res, st = eval_frame_step(model, normalize_uint8(images), mask,
                                      st, *thresholds,
                                      cache.lookup(host_mask))
            rres, rst = ref_frame_step(ref, gen.normalize_uint8(images),
                                       mask, rst, *thresholds)
            for k in ("mask", "ids", "labels"):
                assert torch.equal(res[k], rres[k]), (t, k)
            on = res["mask"]
            live = max(live, int(on.sum()))
            for k in ("boxes", "scores"):
                torch.testing.assert_close(res[k][on], rres[k][on],
                                           rtol=1e-4, atol=1e-5)
            for f in ("query_embed", "ref_pts", "long_memory"):
                torch.testing.assert_close(getattr(st, f)[on],
                                           getattr(rst, f)[on],
                                           rtol=1e-4, atol=1e-4)
    assert live >= 5 and cache.builds == 1


def test_spans_open_in_order_inside_the_encoder(program):
    model, _ = program
    cfg = _config()
    levels, layers = cfg["NUM_FEATURE_LEVELS"], cfg["NUM_ENC_LAYERS"]
    n, c = cfg["TRACK_SLOTS"], cfg["HIDDEN_DIM"]
    st = TrackState.empty(1, n, c, model.num_classes)
    images = torch.randn(1, 64, 96, 3, generator=torch.Generator()
                         .manual_seed(1))
    mask = torch.zeros(1, 64, 96, dtype=torch.bool)
    mask[:, :, 80:] = True
    names = set(SPANS) | {"encoder.fuse", "model.encoder", K2}
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(images, mask, st.query_embed, st.ref_pts, st.mask)
    events = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() in names)
    (enc_lo, enc_hi, _), = [e for e in events if e[2] == "model.encoder"]
    spans = [e for e in events if e[2].startswith("encoder.")]
    assert all(enc_lo <= a and b <= enc_hi for a, b, _ in spans)
    expected = (list(SPANS) * levels + ["encoder.fuse"]) * layers
    assert [name for _, _, name in spans] == expected
    attn = [e for e in spans if e[2] == "encoder.attn"]
    k2 = [e for e in events if e[2] == K2]
    assert len(k2) == levels * layers
    assert all(sum(a <= k[0] and k[1] <= b for a, b, _ in attn) == 1
               for k in k2)
