"""The CUDA window-attention kernel (K2) on the card, against its plain
PyTorch version.

Marked ``gpu``: each test skips without a CUDA device.  This file imports
no JAX, so it also runs on a machine that has only torch:

    python3 -m pytest --noconftest -m gpu tests/test_torch_window_attn_cuda.py

Tolerances: float32 atol 1e-4 / rtol 1e-4 (the kernel sums the
projections, logits and value mix in float32 in another order and keeps the
logits unrounded); bfloat16 against the plain version in float32 on the
same bf16 inputs, atol 5e-2 (the kernel rounds to bf16 between its stages;
the float32 reference does not).
"""
import numpy as np
import pytest
import torch

from memotr_tpu_torch.models.frame_step import model_forward
from memotr_tpu_torch.models.memotr import build_model
from memotr_tpu_torch.ops import window_attn_cuda
from memotr_tpu_torch.ops.window_attn import window_attention_torch
from memotr_tpu_torch.structures.track_state import TrackState

pytestmark = pytest.mark.gpu

# (B, Hp, Wp, C, heads, window_h, window_w, bias, dead window)
CASES = {
    "window_l64": (1, 16, 24, 64, 8, 8, 8, True, False),
    "grid_l312": (1, 13 * 2, 24 * 2, 64, 8, 13, 24, True, True),
    "grid_l6": (2, 4, 6, 32, 4, 2, 3, True, False),
    "awkward_c32": (2, 16, 24, 32, 4, 4, 4, False, True),
    # C not a multiple of 32, head dim 8: the CUDA-core kernels in bf16 too
    "awkward_c24": (1, 8, 12, 24, 3, 4, 4, True, True),
    # the main path's widths (C=256, 8 heads, head dim 32): the fused
    # tensor-core route in bf16
    "main_window_l64": (1, 16, 24, 256, 8, 8, 8, True, True),
    "main_grid_l312": (1, 26, 48, 256, 8, 13, 24, True, True),
    "main_grid_l6": (1, 16, 24, 256, 8, 2, 3, True, False),
    "main_window_b2": (2, 16, 24, 256, 8, 8, 8, False, True),
    # the fused route's other head dims: 16 (groups over 64 keys) and 64
    "fused_dh16_l84": (1, 14, 24, 64, 4, 7, 12, True, True),
    "fused_dh64_l64": (1, 16, 24, 128, 2, 8, 8, True, True),
}


def _route(dtype, c, heads):
    """The route a call takes: the fused tensor-core kernels in bf16 at C a
    multiple of 64 and head dim 16, 32 or 64, else the CUDA-core kernels."""
    fused = (dtype == torch.bfloat16 and c % 64 == 0
             and c // heads in (16, 32, 64))
    return "fused" if fused else "cuda_cores"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(device, dtype, b, h, w, c, heads, wh, ww, with_bias, dead,
            seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    pos = (rng.normal(size=(b, h, w, c)) * 0.5).astype(np.float32)
    mask = np.zeros((b, h, w), bool)
    mask[:, :, w - 3:] = True
    if dead:
        mask[-1, :wh, :ww] = True
    in_w = (rng.normal(size=(3 * c, c)) / np.sqrt(c)).astype(np.float32)
    in_b = (rng.normal(size=(3 * c,)) * 0.1).astype(np.float32)
    out_w = (rng.normal(size=(c, c)) / np.sqrt(c)).astype(np.float32)
    out_b = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    l = wh * ww
    bias = (rng.normal(size=(heads, l, l)) * 0.3).astype(np.float32) \
        if with_bias else None
    dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return ((dev(x).to(dtype), dev(pos).to(dtype), dev(mask), dev(in_w),
             dev(in_b), dev(out_w), dev(out_b),
             None if bias is None else dev(bias)), (heads, wh, ww))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case, dtype):
    args, geo = _inputs(cuda, dtype, *CASES[case])
    before = window_attn_cuda.launches
    route = _route(dtype, CASES[case][3], CASES[case][4])
    routes_before = dict(window_attn_cuda.routes)
    with torch.inference_mode():
        out = window_attn_cuda.window_attention_cuda(*args, *geo)
        ref = window_attention_torch(args[0].float(), args[1].float(),
                                     *args[2:], *geo)
    torch.cuda.synchronize()
    assert window_attn_cuda.launches == before + 1
    assert window_attn_cuda.routes[route] == routes_before[route] + 1, route
    assert out.dtype == dtype and torch.isfinite(out).all()
    atol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=1e-4)


def test_fused_route_allocates_no_qkv_scratch(cuda):
    """bf16 at the main path's widths: the call allocates its output and
    one head-output map, and no (3, B, H, W, C) Q/K/V scratch."""
    args, geo = _inputs(cuda, torch.bfloat16, *CASES["main_grid_l312"])
    with torch.inference_mode():
        window_attn_cuda.window_attention_cuda(*args, *geo)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = window_attn_cuda.window_attention_cuda(*args, *geo)
        torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= 2 * out.nbytes + 4096


def test_kernel_rejects_what_it_does_not_take(cuda):
    args, geo = _inputs(cuda, torch.float32, *CASES["awkward_c32"])
    with pytest.raises(TypeError):
        window_attn_cuda.window_attention_cuda(args[0].half(), args[1].half(),
                                               *args[2:], *geo)
    with pytest.raises(ValueError, match="contiguous"):
        window_attn_cuda.window_attention_cuda(
            args[0].transpose(1, 2).contiguous().transpose(1, 2), *args[1:],
            *geo)
    with pytest.raises(ValueError, match="padded"):
        window_attn_cuda.window_attention_cuda(*args, geo[0], 5, 4)
    with pytest.raises(NotImplementedError, match="training slice"):
        window_attn_cuda.window_attention_cuda(args[0].requires_grad_(),
                                               *args[1:], *geo)


def test_tiny_windowed_frame_on_gpu_matches_cpu(cuda):
    """One float32 frame of a tiny windowed model: CUDA (kernels) vs CPU
    (plain versions)."""
    cfg = {"DATASET": "DanceTrack", "HIDDEN_DIM": 64, "FFN_DIM": 128,
           "NUM_FEATURE_LEVELS": 4, "NUM_HEADS": 8, "NUM_ENC_POINTS": 4,
           "NUM_DEC_POINTS": 4, "NUM_ENC_LAYERS": 2, "NUM_DEC_LAYERS": 3,
           "MERGE_DET_TRACK_LAYER": 1, "NUM_DET_QUERIES": 30,
           "DTYPE": "float32", "ENCODER_TYPE": "windowed", "WINDOW_SIZE": 4}
    torch.manual_seed(0)
    model = build_model(cfg).eval()
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.normal(size=(1, 96, 128, 3)).astype(np.float32))
    mask = torch.zeros(1, 96, 128, dtype=torch.bool)
    mask[:, 72:, 96:] = True
    state = TrackState.empty(1, 4, 64, 1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        ref = model_forward(model, img, mask, state)
        before = window_attn_cuda.launches
        out = model_forward(model.to(cuda), img.to(cuda), mask.to(cuda),
                            TrackState.empty(1, 4, 64, 1, device=cuda))
    assert window_attn_cuda.launches == before + 2 * 4   # 2 layers x 4 levels
    for key in ("pred_logits", "pred_boxes"):
        torch.testing.assert_close(out[key].cpu(), ref[key], atol=1e-3,
                                   rtol=1e-3)
