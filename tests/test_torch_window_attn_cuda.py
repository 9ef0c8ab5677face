"""The CUDA window-attention kernel (K2) on the card, against its plain
PyTorch version.

Marked ``gpu``: each test skips without a CUDA device.  This file imports
no JAX, so it also runs on a machine that has only torch:

    python3 -m pytest --noconftest -m gpu tests/test_torch_window_attn_cuda.py

Tolerances: float32 atol 1e-4 / rtol 1e-4 (the kernel sums the
projections, logits and value mix in float32 in another order and keeps the
logits unrounded); bfloat16 against the plain version in float32 on the
same bf16 inputs, atol 5e-2 (the kernel rounds to bf16 between its stages;
the float32 reference does not).  Backward (through
``WindowAttnFunction``): against autograd of the plain version in float32
on the same (bf16-rounded) inputs and cotangent, every gradient within
1e-4 of its largest element in float32 (sums in another order) and within
3e-2 of it in
bfloat16 (Q, K, V, dO, dQ/dK/dV and g_x/g_pos rounded to bf16, and the
cancellation in dP - rowsum(P dP)), as ``chip_smoke.py`` phase 14 holds
them.  The plain backward is checked against finite differences and JAX on
CPU (test_torch_train_window_attn_grad.py).
"""
import numpy as np
import pytest
import torch

from memotr_tpu_torch.models.frame_step import model_forward
from memotr_tpu_torch.models.memotr import build_model
from memotr_tpu_torch.ops import window_attn_cuda
from memotr_tpu_torch.ops.window_attn import (window_attention,
                                               window_attention_torch)
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
    # the main path's widths (C=256, 8 heads, head dim 32): the wgmma
    # tensor-core route in bf16
    "main_window_l64": (1, 16, 24, 256, 8, 8, 8, True, True),
    "main_grid_l312": (1, 26, 48, 256, 8, 13, 24, True, True),
    "main_grid_l6": (1, 16, 24, 256, 8, 2, 3, True, False),
    "main_window_b2": (2, 16, 24, 256, 8, 8, 8, False, True),
    # the wgmma route's other head dims: 16 (groups over 64 keys) and 64
    "fused_dh16_l84": (1, 14, 24, 64, 4, 7, 12, True, True),
    "fused_dh64_l64": (1, 16, 24, 128, 2, 8, 8, True, True),
    # windowed_stream_b24's level-0 and level-1 shapes at B=2 (800x1536
    # canvas, padded columns, a dead window): the 104x192 windows, and grid
    # groups of 13x24 and 7x12 (the K/V scratch route)
    "cell_window_l64_b2": (2, 104, 192, 256, 8, 8, 8, True, True),
    "cell_grid_l312_b2": (2, 104, 192, 256, 8, 13, 24, True, True),
    "cell_grid_l84_b2": (2, 56, 96, 256, 8, 7, 12, True, True),
}


def _route(dtype, c, heads):
    """The route a call takes: the wgmma kernel in bf16 at C = 64 ... 256
    in steps of 64 and head dim 16, 32 or 64, else the CUDA-core
    kernels."""
    tc = (dtype == torch.bfloat16 and c % 64 == 0 and c <= 256
          and c // heads in (16, 32, 64))
    return "wgmma" if tc else "cuda_cores"


def _scratch_bytes(args, geo):
    """Bytes of each part of the scratch the forward allocates for a call
    (``window_attn_plan``): on the wgmma route the bf16 weights (4C x C),
    the bias table in the attention core's order (heads x R x R, R = 64 or
    L rounded up to 64) and, for groups over 64 keys, K and V of every
    token; no Q and no head outputs."""
    b, h, w, c = args[0].shape
    heads, wh, ww = geo
    l = wh * ww
    r = -(-l // 64) * 64
    table = -(-heads * r * r // 64) * 64 if args[7] is not None else 0
    es = args[0].element_size()
    return {"weights": 4 * c * c * es, "table": table * es,
            "kv": (2 * b * h * w * c if l > 64 else 0) * es}


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
        out = window_attention(*args, *geo)
        ref = window_attention_torch(args[0].float(), args[1].float(),
                                     *args[2:], *geo)
    torch.cuda.synchronize()
    assert window_attn_cuda.launches == before + 1
    assert window_attn_cuda.routes[route] == routes_before[route] + 1, route
    assert out.dtype == dtype and torch.isfinite(out).all()
    atol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=1e-4)


def _peak_bytes(fn):
    """Bytes a call allocates at its peak over what stays allocated."""
    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base, out


def test_fused_route_allocates_no_qkv_scratch(cuda):
    """bf16 at the main path's widths (grid L=312, over 64 keys): the call
    allocates its output and the wgmma route's scratch (bf16 weights, bias
    table, K and V), and no (3, B, H, W, C) Q/K/V scratch."""
    args, geo = _inputs(cuda, torch.bfloat16, *CASES["main_grid_l312"])
    with torch.inference_mode():
        peak, out = _peak_bytes(lambda: window_attention(*args, *geo))
    scratch = _scratch_bytes(args, geo)
    assert peak <= out.nbytes + sum(scratch.values()) + 4096
    assert scratch["kv"] == 2 * out.nbytes      # K and V; Q stays on chip


@pytest.mark.parametrize("case", ["cell_window_l64_b2", "cell_grid_l312_b2"])
def test_no_grad_call_allocates_no_head_output_map(cuda, case):
    """Without a gradient (the ``window_attn_fwd`` op) the wgmma route
    writes no head-output map: the call allocates its output and its
    scratch only, a head-output map's bytes less than the call that keeps
    the head outputs for a backward."""
    args, geo = _inputs(cuda, torch.bfloat16, *CASES[case])
    routes = window_attn_cuda.routes["wgmma"]
    scratch = sum(_scratch_bytes(args, geo).values())
    with torch.inference_mode():
        peak, out = _peak_bytes(lambda: window_attention(*args, *geo))
        kept, _ = _peak_bytes(
            lambda: window_attn_cuda.window_attention_fwd(*args, *geo))
    assert window_attn_cuda.routes["wgmma"] == routes + 4
    # torch's caching allocator hands a request of 10 MiB or more a block
    # rounded up to 2 MiB, and keeps it whole where under 1 MiB would be
    # left: up to 1 MiB a request counts as allocated beyond its bytes
    slack = sum(1 << 20 for n in (out.nbytes, scratch) if n >= 10 << 20)
    assert peak <= out.nbytes + scratch + 4096 + slack
    assert kept >= peak + out.nbytes - (1 << 20)


@pytest.mark.parametrize("case", ["main_window_l64", "main_grid_l312",
                                  "main_grid_l6", "fused_dh16_l84"])
def test_grad_route_head_outputs_match_plain(cuda, case):
    """With a gradient the wgmma route also stores the head outputs O / l
    (window order) that the backward's output-projection gradient reads:
    they match the plain version's (its output projection set to the
    identity) within the bf16 tolerance, and storing them leaves the
    output bit for bit as the no-grad call gives it."""
    args, geo = _inputs(cuda, torch.bfloat16, *CASES[case])
    b, h, w, c = args[0].shape
    with torch.inference_mode():
        out, o = window_attn_cuda.window_attention_fwd(*args, *geo)
        alone, none = window_attn_cuda.window_attention_fwd(
            *args, *geo, head_outputs=False)
        want = window_attention_torch(
            args[0].float(), args[1].float(), args[2], args[3], args[4],
            torch.eye(c, device=cuda), torch.zeros(c, device=cuda), args[7],
            *geo)
    torch.cuda.synchronize()
    assert none is None and torch.equal(out, alone)
    got = window_attn_cuda._merge(o, b, h, w, geo[1], geo[2]).view(b, h, w, c)
    torch.testing.assert_close(got.float(), want, atol=5e-2, rtol=1e-4)


def test_kernel_rejects_what_it_does_not_take(cuda):
    args, geo = _inputs(cuda, torch.float32, *CASES["awkward_c32"])
    with pytest.raises(TypeError):
        window_attention(args[0].half(), args[1].half(), *args[2:], *geo)
    with pytest.raises(ValueError, match="contiguous"):
        window_attention(
            args[0].transpose(1, 2).contiguous().transpose(1, 2), *args[1:],
            *geo)
    with pytest.raises(ValueError, match="padded"):
        window_attention(*args, geo[0], 5, 4)
    with torch.no_grad():
        _, o = window_attn_cuda.window_attention_fwd(*args, *geo)
    with pytest.raises(ValueError, match="grad_out"):
        window_attn_cuda.window_attention_bwd(args[0][:, :8], *args, o, *geo)


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


NAMES = ("x", "pos", "in_proj_weight", "in_proj_bias", "out_weight",
         "out_bias", "bias")


def _grads(fn, args, geo, g, dtype=None):
    """Gradients of every differentiable input of one call, through ``fn``
    (x and pos cast to ``dtype`` where given)."""
    leaves = []
    for i, a in enumerate((args[0], args[1]) + tuple(args[3:])):
        if a is not None:
            a = a.detach().clone()
            a = a.to(dtype) if dtype is not None and i < 2 else a
            a.requires_grad_()
        leaves.append(a)
    out = fn(leaves[0], leaves[1], args[2], *leaves[2:], *geo)
    live = [t for t in leaves if t is not None]
    return [n for n, t in zip(NAMES, leaves) if t is not None], \
        torch.autograd.grad(out, live, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_plain_autograd(cuda, case, dtype):
    args, geo = _inputs(cuda, dtype, *CASES[case])
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(args[0].shape)).astype(np.float32)).to(cuda, dtype)
    fwd, bwd = window_attn_cuda.launches, window_attn_cuda.bwd_launches
    c, heads = CASES[case][3], CASES[case][4]
    # bf16 at head dim 16, 32, 64: one of the two tensor-core routes (whole
    # groups, or tiles of a group where its bias table does not fit a block)
    routes = ("tensor_cores", "tensor_cores_tiled") \
        if dtype == torch.bfloat16 and c // heads in (16, 32, 64) \
        else ("cuda_cores",)
    before = sum(window_attn_cuda.bwd_routes[r] for r in routes)
    names, got = _grads(window_attention, args, geo, g)
    assert window_attn_cuda.launches == fwd + 1
    assert window_attn_cuda.bwd_launches == bwd + 1
    assert sum(window_attn_cuda.bwd_routes[r] for r in routes) == before + 1
    _, want = _grads(window_attention_torch, args, geo, g.float(),
                     torch.float32)
    torch.cuda.synchronize()
    rel = 1e-4 if dtype == torch.float32 else 3e-2
    for name, a, w in zip(names, got, want):
        assert a.dtype == (dtype if name in ("x", "pos") else torch.float32)
        assert torch.isfinite(a).all(), name
        top = w.abs().max().item()
        assert (a.float() - w).abs().max().item() <= rel * top + 1e-7, name


# backward-only cases, (B, Hp, Wp, C, heads, window_h, window_w, bias, dead)
BWD_CASES = {
    # the training canvas's grid level 0 (L=336: the tiled route in bf16),
    # an opened (all-padding) group
    "main_grid_l336": (1, 28, 48, 256, 8, 14, 24, True, True),
    # L=144: just above the first kernel's shared-memory bias limit (128)
    "main_l144": (1, 24, 24, 256, 8, 12, 12, True, True),
    # 13 grid groups and 37 windows: counts no share of the groups divides
    "main_grid_l336_13_groups": (1, 14 * 13, 24, 256, 8, 14, 24, True, False),
    "main_window_37_groups": (1, 8 * 37, 8, 256, 8, 8, 8, True, True),
    # the tiled route at head dims 64 and 16 (float32 at dh=64 and L=336
    # is refused: the CUDA-core kernel's block would not fit)
    "tiled_dh64_l192": (1, 24, 32, 128, 2, 12, 16, True, True),
    "tiled_dh16_l192": (1, 24, 32, 64, 4, 12, 16, True, False),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_backward_large_groups_match_plain_autograd(cuda, case, dtype):
    """Every gradient, the bias table's included, against plain autograd
    (the tolerances of test_backward_matches_plain_autograd) where the bias
    table and its gradient do not fit a block, and at group counts that no
    share of the groups divides."""
    args, geo = _inputs(cuda, dtype, *BWD_CASES[case])
    g = torch.from_numpy(np.random.default_rng(6).normal(
        size=tuple(args[0].shape)).astype(np.float32)).to(cuda, dtype)
    names, got = _grads(window_attention, args, geo, g)
    _, want = _grads(window_attention_torch, args, geo, g.float(),
                     torch.float32)
    torch.cuda.synchronize()
    assert "bias" in names
    rel = 1e-4 if dtype == torch.float32 else 3e-2
    for name, a, w in zip(names, got, want):
        assert torch.isfinite(a).all(), name
        top = w.abs().max().item()
        assert (a.float() - w).abs().max().item() <= rel * top + 1e-7, name


@pytest.mark.parametrize("case", ["main_grid_l336", "main_window_37_groups"])
def test_backward_is_deterministic(cuda, case):
    """No atomic adds a float anywhere in the backward: two calls on the
    same inputs give the same bits, the bias gradient's included."""
    args, geo = _inputs(cuda, torch.bfloat16, *BWD_CASES[case])
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=tuple(args[0].shape)).astype(np.float32)).to(cuda, torch.bfloat16)
    _, first = _grads(window_attention, args, geo, g)
    _, again = _grads(window_attention, args, geo, g)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad"])
def test_no_gradient_no_backward_state(cuda, mode):
    """Parameters that require grad, but no gradient asked for: the forward
    kernel alone, no graph, nothing saved (the call allocates its output
    and the kernel's scratch only) and no backward launch."""
    args, geo = _inputs(cuda, torch.bfloat16, *CASES["main_grid_l312"])
    args = args[:3] + tuple(a.requires_grad_() for a in args[3:])
    ctx = torch.inference_mode if mode == "inference_mode" else torch.no_grad
    fwd, bwd = window_attn_cuda.launches, window_attn_cuda.bwd_launches
    with ctx():
        peak, out = _peak_bytes(lambda: window_attention(*args, *geo))
    assert out.grad_fn is None and not out.requires_grad
    assert peak <= out.nbytes + sum(_scratch_bytes(args, geo).values()) + 4096
    assert window_attn_cuda.launches == fwd + 2
    assert window_attn_cuda.bwd_launches == bwd


def test_tiny_windowed_train_step_on_gpu_matches_cpu(cuda):
    """One float32 train step of a tiny windowed model (2 layers, window 4)
    on a 2-frame clip: CUDA (K1 and K2, forward and backward) vs CPU (the
    plain versions); the losses to 1e-4 relative, the gradient norm to
    1e-3 (float32 sums in another order through the clip, the atomics'
    order run-dependent)."""
    import copy

    from memotr_tpu_torch.data.loader import collate_clips
    from memotr_tpu_torch.engine.trainer import Trainer
    cfg = {"DATASET": "DanceTrack", "HIDDEN_DIM": 64, "FFN_DIM": 128,
           "NUM_FEATURE_LEVELS": 4, "NUM_HEADS": 8, "NUM_ENC_POINTS": 4,
           "NUM_DEC_POINTS": 4, "NUM_ENC_LAYERS": 2, "NUM_DEC_LAYERS": 3,
           "MERGE_DET_TRACK_LAYER": 1, "NUM_DET_QUERIES": 30,
           "DTYPE": "float32", "TRACK_SLOTS": 4, "MAX_GTS": 5,
           "AUX_LOSS_WEIGHT": [1.0, 1.0], "ENCODER_TYPE": "windowed",
           "WINDOW_SIZE": 4}
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
    fwd, bwd = window_attn_cuda.launches, window_attn_cuda.bwd_launches
    out = Trainer(model, cfg, device=cuda).step(batch)
    per_clip = 2 * 2 * 4                 # frames x layers x levels
    assert window_attn_cuda.launches - fwd == per_clip
    assert window_attn_cuda.bwd_launches - bwd == per_clip
    for key in ("total_loss", "label_focal_loss", "box_l1_loss",
                "box_giou_loss"):
        np.testing.assert_allclose(float(out[key]), float(ref[key]),
                                   rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(float(out["grad_norm"]),
                               float(ref["grad_norm"]), rtol=1e-3)
