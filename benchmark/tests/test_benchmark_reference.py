"""The plain reference against the program at small widths in float32 on
the CPU (a few streamed frames of every lane), and the control (the
reference in float8 in the program's place), which each cell's limits
must refuse; the encoder parts the reference finds by file
(``benchmark/reference/models/encoders/<ENCODER_TYPE>.py``), and a
windowed cell that lives in memory only."""
from __future__ import annotations

import pytest
import torch

from benchmark import check, harness
from benchmark.reference.models import encoders
from benchmark.tests.conftest import ROOT, TINY_CONFIG, WINDOWED_YAML

CELLS = [w["name"] for w in harness.spec()["workloads"]]
# float32 on both sides, on the CPU: the stage check runs the same float32
# operations (0 apart); the forward differs only where the program reads
# its eval cache's position maps (numpy) for the reference's torch ones
AGREE = {"logit_rms": 5e-3, "box_rms": 5e-3, "state_gap": 1e-5,
         "state_mismatch": 0.0, "rows_gap": 0.0}
# every ENCODER_TYPE the program builds
PROGRAM_ENCODERS = ("deformable", "windowed", "hybrid", "conv")


def _dab_config(**kw):
    bench = harness.spec()
    return dict(harness.config_of(harness.cell("dab_stream_b8", bench),
                                  bench), **TINY_CONFIG, **kw)


def _windowed_config(**kw):
    import yaml
    return dict(yaml.safe_load(WINDOWED_YAML.read_text()), **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_and_the_control_is_refused(run_tiny, workload):
    r = run_tiny(workload, control=True)
    got = {k: v["value"] for k, v in r["checks"].items()}
    for k, v in got.items():
        assert v <= AGREE[k], (k, v)
    assert r["correct"], r["checks"]
    control = {k: v for k, v in r["control"].items() if k != "details"}
    assert check.judge(control, harness.limits_of(workload)) is False, \
        control


@pytest.mark.parametrize("option", [("USE_DAB", False), ("DROPOUT", 0.1),
                                    ("EXTRA_TRACK_ATTN", True)])
def test_reference_refuses_what_it_does_not_implement(option):
    from benchmark import reference
    cfg = _dab_config()
    reference.build(cfg)
    with pytest.raises(ValueError):
        reference.build(dict(cfg, **dict([option])))


@pytest.mark.parametrize("kind", PROGRAM_ENCODERS)
def test_reference_builds_an_encoder_where_its_part_is(kind):
    """The reference builds an ENCODER_TYPE if and only if its part file
    is there; otherwise the error names the file to add."""
    from benchmark import reference
    cfg = _dab_config(ENCODER_TYPE=kind)
    part = encoders.part_file(kind)
    if part.is_file():
        reference.build(cfg)
    else:
        with pytest.raises(ValueError) as err:
            reference.build(cfg)
        assert str(part.relative_to(ROOT)) in str(err.value)


def test_deformable_part_is_the_encoder_as_it_was():
    """The part is the deformable ``Encoder``: the same parameter names,
    and bit for bit the same forward on a seeded input; the whole model
    keeps the program's names (its weights load strictly)."""
    from benchmark import reference
    from benchmark.reference.models.encoder import Encoder
    from benchmark.reference.models.transformer import \
        valid_ratios_from_masks
    from memotr_tpu_torch.models.memotr import build_model
    cfg = _dab_config()
    part = encoders.build(cfg, torch.float32)
    assert type(part) is Encoder
    direct = Encoder(cfg["NUM_ENC_LAYERS"], cfg["HIDDEN_DIM"],
                     cfg["FFN_DIM"], cfg["NUM_FEATURE_LEVELS"],
                     cfg["NUM_HEADS"], cfg["NUM_ENC_POINTS"])
    assert list(part.state_dict()) == list(direct.state_dict())
    g = torch.Generator().manual_seed(5)
    direct.load_state_dict({k: torch.randn(v.shape, generator=g)
                            for k, v in direct.state_dict().items()})
    part.load_state_dict(direct.state_dict())
    shapes = ((8, 12), (4, 6), (2, 3), (1, 2))
    s, c = sum(h * w for h, w in shapes), cfg["HIDDEN_DIM"]
    masks = [torch.zeros(1, h, w, dtype=torch.bool) for h, w in shapes]
    for m in masks:
        m[:, :, -1] = True
    src, pos = torch.randn(2, 1, s, c, generator=g)
    mask = torch.cat([m.flatten(1) for m in masks], dim=1)
    ratios = valid_ratios_from_masks(masks)
    with torch.no_grad():
        a = part(src, shapes, ratios, pos, mask)
        b = direct(src, shapes, ratios, pos, mask)
    assert torch.equal(a, b)
    model = build_model(cfg)
    ref = reference.build(cfg)
    assert list(ref.state_dict()) == list(model.state_dict())
    ref.load_state_dict(model.state_dict())


def test_windowed_reference_has_the_programs_names_and_shapes():
    """At the published widths of the windowed flagship, on ``meta``."""
    from benchmark import reference
    from memotr_tpu_torch.models.memotr import build_model
    cfg = _windowed_config()
    ref = reference.build(cfg).to("meta")
    prog = build_model(cfg).to("meta")
    assert {k: v.shape for k, v in ref.state_dict().items()} \
        == {k: v.shape for k, v in prog.state_dict().items()}


def test_the_deformable_count_of_operations_stays():
    from benchmark import counting
    bench = harness.spec()
    cfg = harness.config_of(harness.cell("dab_stream_b8", bench), bench)
    assert round(counting.frame_flops(cfg, (800, 1536))["total"] / 1e9,
                 1) == 632.8


OPTIONS = ("WINDOW_SIZE", "WINDOWED_LEPE", "WINDOWED_BOTTOMUP",
           "WINDOWED_RELPOS", "WINDOWED_PRENORM", "WINDOWED_SHARED_CPB")


@pytest.mark.parametrize("values", [(8, True, True, True, False, False),
                                    (4, False, False, False, True, True),
                                    (4, True, True, True, True, True),
                                    (3, True, False, True, False, False)])
def test_windowed_part_matches_the_programs_plain_route(values):
    """The windowed part against the program's encoder on the CPU (its
    plain window attention), with the program's seeded weights loaded
    strictly: levels that are and are not window multiples, padded
    columns in one lane, window and grid layers."""
    from memotr_tpu_torch.models.memotr import build_model
    cfg = _windowed_config(**dict(TINY_CONFIG, NUM_ENC_LAYERS=3,
                                  NUM_HEADS=4), **dict(zip(OPTIONS, values)))
    prog = build_model(cfg).transformer.encoder
    part = encoders.build(cfg, torch.float32)
    g = torch.Generator().manual_seed(11)
    prog.load_state_dict({k: torch.randn(v.shape, generator=g) * 0.3
                          for k, v in prog.state_dict().items()})
    part.load_state_dict(prog.state_dict())
    shapes = ((13, 22), (7, 11), (4, 6), (2, 3))
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
        a = prog(src, shapes, ratios, pos, mask)
        b = part(src, shapes, ratios, pos, mask)
    assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max())


@pytest.mark.parametrize("window", [8, 4])
def test_an_in_memory_windowed_cell_agrees(windowed_cell, window):
    """The windowed configuration as a cell made of new files only (here
    in memory and under ``tmp_path``): every reading within ``AGREE``.
    At 64x128 the levels are 8x16, 4x8, 2x4 and 1x2: with window 8 all but
    the first, with window 4 the last two, are no window multiple."""
    _, run = windowed_cell(WINDOW_SIZE=window)
    r = run()
    got = {k: v["value"] for k, v in r["checks"].items()}
    assert set(got) == set(AGREE)
    for k, v in got.items():
        assert v <= AGREE[k], (k, v)
    assert r["failed"] == 0
