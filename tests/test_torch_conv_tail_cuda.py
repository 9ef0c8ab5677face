"""The conv_tail kernel and the folded backbone on the card.

Marked ``gpu``: each test skips without a CUDA device.  This file imports
no JAX, so it also runs on a machine that has only torch:

    python3 -m pytest --noconftest -m gpu tests/test_torch_conv_tail_cuda.py

The kernel takes the same float32 sums as the plain version
(``ops/conv_tail.py: conv_tail_torch``: y + bias, then + identity, ReLU,
one rounding), so it must equal it bit for bit, and lie within one ulp of
the output dtype of that float32 sum.  The whole bf16 backbone,
folded against unfolded, is held as on the CPU
(``tests/test_torch_backbone_fold.py``).
"""
import pytest
import torch

from memotr_tpu_torch.models import resnet
from memotr_tpu_torch.ops import conv_tail as ct
from memotr_tpu_torch.ops.library import conv_tail
from test_torch_backbone_fold import rms, weights_

pytestmark = pytest.mark.gpu

# (C, H, W) of the backbone's tails on the 800x1536 canvas, and whether
# they add the block's identity (each bottleneck's conv3)
TAILS = {"stem": (64, 400, 768, False),
         "layer1_conv1": (64, 200, 384, False),
         "layer1_conv3": (256, 200, 384, True),
         "layer2_conv2": (128, 100, 192, False),
         "layer2_conv3": (512, 100, 192, True),
         "layer3_conv1": (256, 100, 192, False),
         "layer3_conv3": (1024, 50, 96, True),
         "layer4_conv2": (512, 25, 48, False),
         "layer4_conv3": (2048, 25, 48, True)}
# off the main path: no ReLU, no identity, a row of 3 vectors (C=24, so
# blocks of 255 threads), float32 (4 channels a vector; 512 a row at 2048)
OTHER = [(torch.bfloat16, 2, 256, 13, 17, True, False),
         (torch.bfloat16, 2, 256, 13, 17, False, False),
         (torch.bfloat16, 3, 24, 9, 11, True, True),
         (torch.float32, 2, 64, 50, 96, True, True),
         (torch.float32, 1, 2048, 25, 48, True, True),
         (torch.float32, 2, 12, 7, 5, False, False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def draw(device, dtype, n, c, h, w, seed):
    """A channels_last map, its identity and a float32 bias."""
    g = torch.Generator(device=device).manual_seed(seed)
    y, identity = (torch.randn((n, c, h, w), generator=g, device=device).to(
        dtype, memory_format=torch.channels_last) for _ in range(2))
    return y, identity, torch.randn(c, generator=g, device=device)


def check(y, bias, identity, relu):
    """One op call against the plain version and the float32 sum."""
    want = ct.conv_tail_torch(y, bias, identity, relu)
    exact = y.float() + bias.view(1, -1, 1, 1)
    if identity is not None:
        exact = exact + identity.float()
    if relu:
        exact = exact.clamp_min(0)
    got = y.clone()
    before = ct.launches
    conv_tail(got, bias, identity, relu)
    torch.cuda.synchronize()
    assert ct.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    eps = torch.finfo(y.dtype).eps              # 2 ** -(mantissa bits)
    ulp = eps * torch.exp2(torch.floor(torch.log2(
        exact.abs().clamp_min(1e-30))))
    assert bool(((got.float() - exact).abs() <= ulp).all())


@pytest.mark.parametrize("batch", [8, 1])
@pytest.mark.parametrize("tail", sorted(TAILS))
def test_kernel_at_the_backbone_shapes(cuda, tail, batch):
    c, h, w, with_identity = TAILS[tail]
    y, identity, bias = draw(cuda, torch.bfloat16, batch, c, h, w, seed=1)
    with torch.inference_mode():
        check(y, bias, identity if with_identity else None, True)


@pytest.mark.parametrize("dtype, n, c, h, w, with_identity, relu", OTHER)
def test_kernel_off_the_main_path(cuda, dtype, n, c, h, w, with_identity,
                                  relu):
    y, identity, bias = draw(cuda, dtype, n, c, h, w, seed=2)
    with torch.inference_mode():
        check(y, bias, identity if with_identity else None, relu)


def test_kernel_rejects_what_it_does_not_take(cuda):
    y, identity, bias = draw(cuda, torch.bfloat16, 2, 64, 6, 10, seed=3)
    with pytest.raises(ValueError, match="channels_last"):
        conv_tail(y.contiguous(), bias, None, True)
    with pytest.raises(ValueError, match="identity"):
        conv_tail(y, bias, identity.contiguous(), True)
    with pytest.raises(ValueError, match="identity"):
        conv_tail(y, bias, y, True)
    with pytest.raises(ValueError, match="bias"):
        conv_tail(y, bias.to(torch.bfloat16), None, True)
    with pytest.raises(TypeError):
        conv_tail(y.half(), bias, None, True)
    y4, _, b4 = draw(cuda, torch.bfloat16, 1, 4, 6, 10, seed=4)
    with pytest.raises(ValueError, match="16 bytes"):
        conv_tail(y4, b4, None, True)
    with pytest.raises(ValueError, match="CUDA"):
        ct.conv_tail_cuda(y.cpu(), bias.cpu(), None, True)


def test_launch_counter_counts_each_call(cuda):
    y, identity, bias = draw(cuda, torch.bfloat16, 1, 64, 8, 8, seed=5)
    before = ct.launches
    for i in range(3):
        conv_tail(y, bias, identity if i else None, bool(i % 2))
    assert ct.launches == before + 3


def test_backbone_folded_vs_unfolded_on_the_card(cuda):
    """The bf16 backbone at B=2 on the 800x1536 canvas: the folded route
    (49 tails, one fold) no farther from the float32 maps (TF32 off) than
    the unfolded bf16 route, and close to it."""
    net = weights_(resnet.ResNet50(torch.bfloat16), 12).to(cuda)
    net32 = weights_(resnet.ResNet50(torch.float32), 12).to(cuda)
    for p in [*net.parameters(), *net32.parameters()]:
        p.requires_grad_(False)
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn((2, 800, 1536, 3), generator=g,
                    device=cuda).permute(0, 3, 1, 2)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.enable_grad():          # no parameter needs one
            ref = net(x)
            ref32 = net32(x)
        launches, builds = ct.launches, resnet.fold_builds
        with torch.inference_mode():
            out = net(x)
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert ct.launches == launches + 49
    assert resnet.fold_builds == builds + 1
    for level, (o, r, r32) in enumerate(zip(out, ref, ref32)):
        assert o.dtype == torch.bfloat16 and o.shape == r.shape
        assert rms(o, r) < 0.03 * r32.pow(2).mean().sqrt().item(), level
        assert rms(o, r32) <= rms(r, r32), level
