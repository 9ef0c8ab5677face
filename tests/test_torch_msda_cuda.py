"""The CUDA MSDA kernel on the card, against its plain PyTorch version.

Marked ``gpu``: each test skips without a CUDA device.  This file imports
no JAX, so it also runs on a machine that has only torch:

    python3 -m pytest --noconftest -m gpu tests/test_torch_msda_cuda.py

(``--noconftest``: tests/conftest.py configures JAX).  Tolerances: float32
atol 1e-5 / rtol 1e-4 (sums in another order); bfloat16 against the plain
version in float32 on the same bf16-rounded inputs, atol 2e-2.
"""
import numpy as np
import pytest
import torch

from memotr_tpu_torch.models.frame_step import model_forward
from memotr_tpu_torch.models.memotr import build_model
from memotr_tpu_torch.ops import msda_cuda
from memotr_tpu_torch.ops.msda import ms_deform_attn_torch
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
        out = msda_cuda.ms_deform_attn_cuda(v, shapes, loc, aw)
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
        msda_cuda.ms_deform_attn_cuda(v.half(), shapes, loc, aw)
    with pytest.raises(ValueError, match="contiguous"):
        msda_cuda.ms_deform_attn_cuda(v, shapes, loc.transpose(1, 2), aw)
    with pytest.raises(ValueError, match="head dim"):
        msda_cuda.ms_deform_attn_cuda(v[..., :12].contiguous(), shapes, loc,
                                      aw)
    with pytest.raises(NotImplementedError, match="training slice"):
        msda_cuda.ms_deform_attn_cuda(v.requires_grad_(), shapes, loc, aw)


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
