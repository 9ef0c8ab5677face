"""The CUDA MSDA kernels on the card, against their plain PyTorch version.

Marked ``gpu``: each test skips without a CUDA device.  This file imports
no JAX, so it also runs on a machine that has only torch:

    python3 -m pytest --noconftest -m gpu tests/test_torch_msda_cuda.py

(``--noconftest``: tests/conftest.py configures JAX).  Forward tolerances:
float32 atol 1e-5 / rtol 1e-4 (sums in another order); bfloat16 against
the plain version in float32 on the same bf16-rounded inputs, atol 2e-2.
Backward: against autograd of the plain version in float32 on the same
(bf16-rounded) inputs and cotangent.  grad_loc and grad_aw within 1e-5 of
their largest element (float32 sums of up to 4 D corner products in
another order); grad_value the same in float32 (summed by bilinear cell in
float32, in an order that depends on the run), and rtol 8e-3 in bfloat16
(one rounding of the float32 sum to bf16, 2^-8 relative).  The plain
backward is checked against finite differences and JAX on CPU
(test_torch_train_msda_grad.py).
"""
import numpy as np
import pytest
import torch

from memotr_tpu_torch.models.frame_step import model_forward
from memotr_tpu_torch.models.memotr import build_model
from memotr_tpu_torch.ops import msda_cuda
from memotr_tpu_torch.ops.msda import ms_deform_attn, ms_deform_attn_torch
from memotr_tpu_torch.structures.track_state import TrackState

pytestmark = pytest.mark.gpu

CASES = {
    "oob_b2": dict(b=2, m=4, d=16, lq=10, p=3,
                   shapes=((12, 17), (6, 9), (3, 5))),
    "decoder_like_b2": dict(b=2, m=8, d=32, lq=364, p=4,
                            shapes=((25, 48), (13, 24), (7, 12), (4, 6))),
    "single_level_d8": dict(b=1, m=1, d=8, lq=4, p=2, shapes=((7, 7),)),
    "d4": dict(b=1, m=2, d=4, lq=9, p=2, shapes=((9, 12), (5, 6))),
    "d64": dict(b=1, m=2, d=64, lq=33, p=2, shapes=((5, 5), (3, 3))),
    # the decoder's size at B=2 (the launcher splits each (b, q, m)'s
    # samples over lanes at this size), with out-of-bounds taps
    "decoder_b2_main": dict(b=2, m=8, d=32, lq=364, p=4,
                            shapes=((100, 192), (50, 96), (25, 48), (13, 24))),
    # Lq * M not a multiple of a block's (b, q, m) groups
    "ragged_lq": dict(b=1, m=8, d=32, lq=1001, p=4,
                      shapes=((25, 48), (13, 24), (7, 12), (4, 6))),
    # L * P odd: no four-sample loads, split samples of 3 levels x 3 points
    "odd_lp_d16": dict(b=1, m=2, d=16, lq=7, p=3,
                       shapes=((11, 17), (6, 9), (3, 5))),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(device, dtype, b, m, d, lq, p, shapes, seed=0):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.normal(size=(b, s, m, d)).astype(np.float32)
    loc = rng.uniform(-0.15, 1.15, size=(b, lq, m, len(shapes), p, 2)
                      ).astype(np.float32)
    w = rng.uniform(size=(b, lq, m, len(shapes), p)).astype(np.float32)
    w = w / w.sum(axis=(-1, -2), keepdims=True)
    return (torch.from_numpy(value).to(device, dtype),
            torch.from_numpy(loc).to(device), torch.from_numpy(w).to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case, dtype):
    shapes = CASES[case]["shapes"]
    v, loc, aw = _inputs(cuda, dtype, **CASES[case])
    before = msda_cuda.launches
    with torch.inference_mode():
        out = ms_deform_attn(v, shapes, loc, aw)
        ref = ms_deform_attn_torch(v.float(), shapes, loc, aw)
    torch.cuda.synchronize()
    assert msda_cuda.launches == before + 1
    assert out.dtype == dtype
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=1e-4)


def test_kernel_rejects_what_it_does_not_take(cuda):
    shapes = CASES["oob_b2"]["shapes"]
    v, loc, aw = _inputs(cuda, torch.float32, **CASES["oob_b2"])
    with pytest.raises(TypeError):
        ms_deform_attn(v.half(), shapes, loc, aw)
    with pytest.raises(ValueError, match="contiguous"):
        ms_deform_attn(v, shapes, loc.transpose(1, 2), aw)
    with pytest.raises(ValueError, match="head dim"):
        ms_deform_attn(v[..., :12].contiguous(), shapes, loc, aw)
    with pytest.raises(ValueError, match="grad_out"):
        msda_cuda.msda_backward(v, shapes, loc, aw,
                                torch.zeros(1, device=cuda))
    # a gradient asked for goes through the autograd Function
    out = ms_deform_attn(v.requires_grad_(), shapes, loc, aw)
    assert type(out.grad_fn).__name__ == "MSDeformAttnFunctionBackward"


def test_tiny_model_frame_on_gpu_matches_cpu(cuda):
    """One float32 frame of a tiny model: CUDA (kernel) vs CPU (plain)."""
    cfg = {"DATASET": "DanceTrack", "HIDDEN_DIM": 64, "FFN_DIM": 128,
           "NUM_FEATURE_LEVELS": 4, "NUM_HEADS": 8, "NUM_ENC_POINTS": 4,
           "NUM_DEC_POINTS": 4, "NUM_ENC_LAYERS": 2, "NUM_DEC_LAYERS": 3,
           "MERGE_DET_TRACK_LAYER": 1, "NUM_DET_QUERIES": 30,
           "DTYPE": "float32"}
    torch.manual_seed(0)
    model = build_model(cfg).eval()
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.normal(size=(1, 96, 128, 3)).astype(np.float32))
    mask = torch.zeros(1, 96, 128, dtype=torch.bool)
    mask[:, 80:] = True
    state = TrackState.empty(1, 4, 64, 1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        ref = model_forward(model, img, mask, state)
        before = msda_cuda.launches
        out = model_forward(model.to(cuda), img.to(cuda), mask.to(cuda),
                            TrackState.empty(1, 4, 64, 1, device=cuda))
    assert msda_cuda.launches == before + 5          # 2 encoder + 3 decoder
    for key in ("pred_logits", "pred_boxes"):
        torch.testing.assert_close(out[key].cpu(), ref[key], atol=1e-4,
                                   rtol=1e-4)


def _grads(fn, v, loc, aw, g):
    v, loc, aw = (t.detach().clone().requires_grad_() for t in (v, loc, aw))
    fn(v, loc, aw).backward(g)
    return v.grad, loc.grad, aw.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_plain_autograd(cuda, case, dtype):
    shapes = CASES[case]["shapes"]
    v, loc, aw = _inputs(cuda, dtype, **CASES[case])
    b, lq, m = loc.shape[:3]
    g = torch.randn((b, lq, m * v.shape[3]), generator=torch.Generator(
        cuda).manual_seed(1), device=cuda).to(dtype)
    before = msda_cuda.bwd_launches
    got = _grads(lambda *a: ms_deform_attn(a[0], shapes, *a[1:]),
                 v, loc, aw, g)
    torch.cuda.synchronize()
    assert msda_cuda.bwd_launches == before + 1
    want = _grads(lambda *a: ms_deform_attn_torch(a[0], shapes, *a[1:]),
                  v.float(), loc, aw, g.float())
    assert got[0].dtype == dtype
    for name, x, y in zip(("value", "loc", "aw"), got, want):
        scale = y.abs().max().item()
        rtol = 8e-3 if (name == "value" and dtype == torch.bfloat16) else 0
        torch.testing.assert_close(x.float(), y, rtol=rtol,
                                   atol=1e-5 * scale + 1e-7, msg=name)


def test_backward_of_out_of_bounds_taps_is_zero(cuda):
    """Every tap outside the map: zero gradients, nothing scattered."""
    shapes = CASES["d4"]["shapes"]
    v, loc, aw = _inputs(cuda, torch.float32, **CASES["d4"])
    loc = loc.clone()
    loc[..., 0] = 1.0 + 1.0 / min(w for _, w in shapes)
    g = torch.ones((1, loc.shape[1], 2 * 4), device=cuda)
    for t in _grads(lambda *a: ms_deform_attn(a[0], shapes, *a[1:]),
                    v, loc, aw, g):
        assert torch.count_nonzero(t) == 0


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad"])
def test_forward_without_grad_launches_no_backward_and_saves_nothing(cuda,
                                                                     mode):
    shapes = CASES["decoder_b2_main"]["shapes"]
    v, loc, aw = _inputs(cuda, torch.bfloat16, **CASES["decoder_b2_main"])
    v.requires_grad_()
    torch.cuda.synchronize()
    fwd, bwd = msda_cuda.launches, msda_cuda.bwd_launches
    base = torch.cuda.memory_allocated(cuda)
    with getattr(torch, mode)():
        out = ms_deform_attn(v, shapes, loc, aw)
    torch.cuda.synchronize()
    assert out.grad_fn is None
    assert msda_cuda.launches == fwd + 1 and msda_cuda.bwd_launches == bwd
    # the output is the only new allocation (the caching allocator rounds
    # it up to its block size)
    assert torch.cuda.memory_allocated(cuda) - base <= \
        out.numel() * out.element_size() + 2 ** 20


def test_tiny_train_step_on_gpu_matches_cpu(cuda):
    """One float32 train step of a tiny model on a 2-frame clip: CUDA
    (both kernels) vs CPU (plain version); the losses to 1e-4 relative,
    the gradient norm to 1e-3 (float32 sums in another order through the
    clip, the atomics' order run-dependent)."""
    import copy

    from memotr_tpu_torch.data.loader import collate_clips
    from memotr_tpu_torch.engine.trainer import Trainer
    cfg = {"DATASET": "DanceTrack", "HIDDEN_DIM": 64, "FFN_DIM": 128,
           "NUM_FEATURE_LEVELS": 4, "NUM_HEADS": 8, "NUM_ENC_POINTS": 4,
           "NUM_DEC_POINTS": 4, "NUM_ENC_LAYERS": 2, "NUM_DEC_LAYERS": 3,
           "MERGE_DET_TRACK_LAYER": 1, "NUM_DET_QUERIES": 30,
           "DTYPE": "float32", "TRACK_SLOTS": 4, "MAX_GTS": 5,
           "AUX_LOSS_WEIGHT": [1.0, 1.0]}
    rng = np.random.default_rng(2)
    items = [{"imgs": [rng.normal(size=(96, 128, 3)).astype(np.float32)
                       for _ in range(2)],
              "infos": [{"boxes": rng.uniform(0.2, 0.4, (3, 4)),
                         "ids": np.arange(3), "labels": np.zeros(3, int),
                         "areas": np.ones(3)} for _ in range(2)]}]
    batch = collate_clips(items, cfg["MAX_GTS"])
    torch.manual_seed(0)
    model = build_model(cfg)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = Trainer(copy.deepcopy(model), cfg, device="cpu").step(batch)
    fwd, bwd = msda_cuda.launches, msda_cuda.bwd_launches
    out = Trainer(model, cfg, device=cuda).step(batch)
    assert msda_cuda.launches - fwd == 2 * 5       # 2 frames x (2 + 3)
    assert msda_cuda.bwd_launches - bwd == 2 * 5
    for key in ("total_loss", "label_focal_loss", "box_l1_loss",
                "box_giou_loss"):
        np.testing.assert_allclose(float(out[key]), float(ref[key]),
                                   rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(float(out["grad_norm"]),
                               float(ref["grad_norm"]), rtol=1e-3)


def _check_backward(cuda, shapes, v, loc, aw, seed=1):
    """The kernel's three gradients against plain autograd (the tolerances
    of test_backward_matches_plain_autograd)."""
    b, lq, m = loc.shape[:3]
    g = torch.randn((b, lq, m * v.shape[3]), generator=torch.Generator(
        cuda).manual_seed(seed), device=cuda).to(v.dtype)
    got = msda_cuda.msda_backward(v, shapes, loc, aw, g)
    torch.cuda.synchronize()
    want = _grads(lambda *a: ms_deform_attn_torch(a[0], shapes, *a[1:]),
                  v.float(), loc, aw, g.float())
    for name, x, y in zip(("value", "loc", "aw"), got, want):
        assert torch.isfinite(x).all(), name
        scale = y.abs().max().item()
        rtol = 8e-3 if (name == "value" and v.dtype == torch.bfloat16) else 0
        torch.testing.assert_close(x.float(), y, rtol=rtol,
                                   atol=1e-5 * scale + 1e-7, msg=name)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 2])
def test_backward_every_sample_in_one_bucket(cuda, b, dtype):
    """Every location at one point: each level's samples of a head all land
    in one bilinear cell, the longest bucket the value rows gather from (at
    B=2 a batch's buckets stay its own)."""
    case = dict(CASES["decoder_b2_main"], b=b)
    shapes = case["shapes"]
    v, loc, aw = _inputs(cuda, dtype, **case)
    # 0.3712 x size - 0.5 has a nonzero fraction at every level, so all
    # four corners of each cell get a weight
    loc = torch.full_like(loc, 0.3712)
    grads = _check_backward(cuda, shapes, v, loc, aw)
    # only the 4 corner rows of each level get a gradient
    rows = (grads[0].float().abs().sum((2, 3)) > 0).sum(1)
    assert rows.tolist() == [4 * len(shapes)] * b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 2])
def test_backward_at_map_edges_and_outside(cuda, b, dtype):
    """Locations on the maps' edges (corner rows at the first and last row
    and column of every level, beside the next level's rows), on whole
    pixels (fractions 0), just inside and just outside the map."""
    case = CASES["decoder_b2_main"]
    shapes = case["shapes"]
    v, loc, aw = _inputs(cuda, dtype, **dict(case, b=b))
    rng = np.random.default_rng(5)
    w_min = min(w for _, w in shapes)
    picks = np.asarray([0.0, 1.0, 0.5 / w_min, 1 - 0.5 / w_min, -0.49 / w_min,
                        1 + 0.49 / w_min, -0.51 / w_min * 2, 1.5, 0.5],
                       np.float32)
    loc = torch.from_numpy(rng.choice(picks, size=tuple(loc.shape))).to(cuda)
    # on whole pixels of each level: x W - 0.5 an integer
    for l, (h, w) in enumerate(shapes):
        loc[:, :8, :, l, :, 0] = (torch.arange(8, device=cuda)[:, None, None]
                                  % w + 0.5) / w
        loc[:, :8, :, l, :, 1] = (h - 0.5) / h
    _check_backward(cuda, shapes, v, loc, aw)


def test_backward_routes_decoder_and_encoder_sizes(cuda):
    """The decoder's size (samples split over lanes) and an encoder-like
    size (one (b, q, m) a group) at B=2, bf16: every value row written (no
    stale workspace from the call before), the same result twice up to the
    order of float32 sums."""
    for lq in (364, 4000):
        case = dict(CASES["decoder_b2_main"], lq=lq)
        shapes = case["shapes"]
        v, loc, aw = _inputs(cuda, torch.bfloat16, **case)
        first = _check_backward(cuda, shapes, v, loc, aw, seed=3)
        again = _check_backward(cuda, shapes, v, loc, aw, seed=3)
        scale = first[0].float().abs().max().item()
        torch.testing.assert_close(first[0].float(), again[0].float(),
                                   atol=1e-5 * scale, rtol=8e-3)
        assert torch.equal(first[1], again[1]) and torch.equal(first[2],
                                                               again[2])
