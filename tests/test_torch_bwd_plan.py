"""The host-side planning of the port's two backward kernels, on the CPU.

``ops/msda_cuda.py`` sizes K1 backward's workspace from the levels' bilinear
cells, and ``ops/window_attn_cuda.py`` sizes K2 backward's scratch from the
kernel's plan; both are pure functions checked here.  The K1 backward's
decomposition of grad_value (each sample filed under the cell whose corners
it reads, a cell's four corner sums, each value row the sum of the corners
of the four cells that touch it) is replayed in numpy and held against
autograd of the plain version: the arithmetic the CUDA kernels follow,
checkable without a card.
"""
import numpy as np
import pytest
import torch

from memotr_tpu_torch.ops import msda_cuda, window_attn_cuda
from memotr_tpu_torch.ops.msda import ms_deform_attn_torch

SHAPES = ((5, 7), (3, 4), (2, 2))


def test_cell_count_is_every_cell_a_sample_can_fall_in():
    """A sample inside (-1, W) x (-1, H) has its top-left corner at
    x0 in [-1, W-1], y0 in [-1, H-1]: (H+1)(W+1) cells a level."""
    seen = 0
    for h, w in SHAPES:
        px = np.linspace(-0.999, w - 0.001, 97)
        py = np.linspace(-0.999, h - 0.001, 89)
        x0, y0 = np.floor(px).astype(int), np.floor(py).astype(int)
        seen += len(set(x0.tolist())) * len(set(y0.tolist()))
    assert msda_cuda.cell_count(SHAPES) == seen == 6 * 8 + 4 * 5 + 3 * 3


@pytest.mark.parametrize("b,lq,m,d,p,want", [
    # 2 samples; 12 buckets of 4 corners x 4 channels; one scan tile
    (1, 2, 1, 4, 1, 5 * 2 + (4 * 4 + 2) * 12 + 1),
    # the encoder of the 896x1536 training canvas: 3.66 M samples, 233 K
    # buckets, 57 scan tiles
    (1, 28560, 8, 32, 4, None),
])
def test_msda_bwd_workspace(b, lq, m, d, p, want):
    shapes = ((2, 3),) if want is not None else \
        ((112, 192), (56, 96), (28, 48), (14, 24))
    samples = b * lq * m * len(shapes) * p
    buckets = b * msda_cuda.cell_count(shapes) * m
    got = msda_cuda.msda_bwd_workspace(b, lq, m, d, p, shapes)
    if want is not None:
        assert got == want
    assert got == 5 * samples + (4 * d + 2) * buckets + \
        -(-buckets // msda_cuda.SCAN_TILE)
    if want is None:
        assert buckets == 8 * 29134 and -(-buckets // msda_cuda.SCAN_TILE) == 57


def test_window_bwd_scratch_shapes():
    got = window_attn_cuda.bwd_scratch(3, 2 * 8 * 21504, 21504, 256, 8, 336)
    assert got == {"proj": (4, 8, 21504, 32), "wmask": (21504,),
                   "fws": (3 * 8 * 336 * 336 + 2 * 8 * 21504,)}
    # no bias, whole-group route: no partial table, no row statistics
    assert window_attn_cuda.bwd_scratch(0, 0, 64, 32, 4, 16)["fws"] == (0,)


def _cell_replay(value, shapes, loc, aw, g):
    """grad_value the way msda_bwd.cu sums it, in float64."""
    b, s, m, d = value.shape
    lq, nl, npt = loc.shape[1], loc.shape[3], loc.shape[4]
    part = [np.zeros((b, h + 1, w + 1, m, 4, d)) for h, w in shapes]
    for bi in range(b):
        for q in range(lq):
            for mi in range(m):
                for li, (h, w) in enumerate(shapes):
                    for pi in range(npt):
                        x, y = loc[bi, q, mi, li, pi]
                        px, py = x * w - 0.5, y * h - 0.5
                        if not (-1 < px < w and -1 < py < h):
                            continue
                        x0, y0 = int(np.floor(px)), int(np.floor(py))
                        fx, fy = px - x0, py - y0
                        wt = ((1 - fx) * (1 - fy), fx * (1 - fy),
                              (1 - fx) * fy, fx * fy)
                        a = aw[bi, q, mi, li, pi]
                        for c in range(4):
                            part[li][bi, y0 + 1, x0 + 1, mi, c] += \
                                a * wt[c] * g[bi, q, mi]
    out = np.zeros((b, s, m, d))
    start = 0
    for li, (h, w) in enumerate(shapes):
        pl = part[li]
        rows = (pl[:, 1:, 1:, :, 0] + pl[:, 1:, :-1, :, 1] +
                pl[:, :-1, 1:, :, 2] + pl[:, :-1, :-1, :, 3])
        out[:, start:start + h * w] = rows.reshape(b, h * w, m, d)
        start += h * w
    return out


def test_cell_decomposition_of_grad_value_matches_autograd():
    """Samples inside, on the edges of and outside every level, two
    batches: the cells' corner sums gathered by row give autograd's
    grad_value."""
    rng = np.random.default_rng(0)
    b, lq, m, d, p = 2, 6, 2, 4, 3
    s = sum(h * w for h, w in SHAPES)
    value = rng.normal(size=(b, s, m, d)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, size=(b, lq, m, len(SHAPES), p, 2))
    loc[0, 0, :, :, 0] = 0.0                     # px = -0.5: column x0 = -1
    loc[0, 1, :, :, 0] = 1.0                     # px = W - 0.5: x0 = W - 1
    loc = loc.astype(np.float32)
    aw = rng.uniform(size=(b, lq, m, len(SHAPES), p)).astype(np.float32)
    g = rng.normal(size=(b, lq, m, d)).astype(np.float32)
    v = torch.from_numpy(value).requires_grad_()
    out = ms_deform_attn_torch(v, SHAPES, torch.from_numpy(loc),
                               torch.from_numpy(aw))
    out.backward(torch.from_numpy(g).reshape(b, lq, m * d))
    got = _cell_replay(value, SHAPES, loc, aw, g)
    np.testing.assert_allclose(got, v.grad.numpy(), rtol=1e-5, atol=1e-5)
