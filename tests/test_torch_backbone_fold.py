"""The backbone's folded inference route (``models/resnet.py``) on the CPU.

A bf16 ``ResNet50`` without a gradient folds each frozen BatchNorm into
its convolution, once per weight set, and ends each convolution in the
``conv_tail`` op (here its plain version).  These tests hold the folded
route to the unfolded one (the JAX package's arithmetic, which training
and float32 models keep), check when the route engages and when its
folded weights are rebuilt, and export it.  The kernel itself is checked
on the card (``tests/test_torch_conv_tail_cuda.py``).

Tolerances: float32, folded against unfolded, within 1e-5 of the largest
element (the same products in another order: the scale multiplies the
weight instead of the output).
bfloat16: the folded route rounds each convolution's output twice where
the unfolded one rounds it three or four times, so against the float32
maps its RMS gap may be no larger than the unfolded bf16 route's, and the
two bf16 routes agree within a few bf16 roundings carried through 16
blocks (RMS gap under 3% of the maps' RMS).
"""
import pytest
import torch

from memotr_tpu_torch.models import resnet
from memotr_tpu_torch.ops import library

X_SHAPE = (2, 3, 64, 96)


def weights_(net: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter and buffer drawn; unit-gain convolutions and
    BatchNorms near the identity keep activations O(1) through 16 blocks."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in [*net.named_parameters(), *net.named_buffers()]:
            if "running_var" in name:
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif t.dim() == 4:
                t.copy_(torch.randn(t.shape, generator=g)
                        / t[0].numel() ** 0.5)
            else:
                t.copy_(torch.randn(t.shape, generator=g) * 0.3
                        + (1.0 if name.endswith("weight") else 0.0))
    return net


def image(seed: int = 0) -> torch.Tensor:
    """An NCHW image with channels_last strides, as ``MeMOTR`` feeds it."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(X_SHAPE[0], *X_SHAPE[2:], X_SHAPE[1], generator=g)
    return x.permute(0, 3, 1, 2)


def unfolded(net: resnet.ResNet50, x: torch.Tensor):
    """The unfolded route, written out from the modules' own forwards."""
    x = torch.nn.functional.relu(net.bn1(net.conv1(x)))
    x = net.layer1(torch.nn.functional.max_pool2d(x, 3, stride=2, padding=1))
    c3 = net.layer2(x)
    c4 = net.layer3(c3)
    return c3, c4, net.layer4(c4)


@pytest.fixture
def tails(monkeypatch):
    """Counts calls of the ``conv_tail`` op from the backbone."""
    calls = []
    op = library.conv_tail

    def counted(*args):
        calls.append(args[2] is not None)
        return op(*args)
    monkeypatch.setattr(library, "conv_tail", counted)
    return calls


def rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).pow(2).mean().sqrt().item()


def test_bf16_inference_takes_the_folded_route(tails):
    net = weights_(resnet.ResNet50(torch.bfloat16), 3)
    net32 = weights_(resnet.ResNet50(torch.float32), 3)
    x = image()
    ref = unfolded(net, x)
    ref32 = unfolded(net32, x)
    before = resnet.fold_builds
    with torch.inference_mode():
        out = net(x)
    assert resnet.fold_builds == before + 1
    # the stem and three a bottleneck; the 16 third ones add the identity
    assert len(tails) == 49 and sum(tails) == 16
    for level, (o, r, r32) in enumerate(zip(out, ref, ref32)):
        assert o.dtype == torch.bfloat16 and o.shape == r.shape
        assert o.is_contiguous(memory_format=torch.channels_last)
        assert rms(o, r) < 0.03 * r32.pow(2).mean().sqrt().item(), level
        assert rms(o, r32) <= rms(r, r32), level


def test_float32_folded_route_matches_unfolded():
    net = weights_(resnet.ResNet50(torch.float32), 4)
    x = image(1)
    with torch.no_grad():
        ref = unfolded(net, x)
        out = net.forward_folded(x)
    for o, r in zip(out, ref):
        assert (o - r).abs().max() <= 1e-5 * r.abs().max()


@pytest.mark.parametrize("dtype, mode", [(torch.bfloat16, "grad"),
                                         (torch.float32, "inference_mode"),
                                         (torch.float32, "grad")])
def test_unfolded_route_with_grad_or_float32(tails, dtype, mode):
    """Training (grad on) and float32 models run the unfolded code: no fold,
    no tail, outputs and parameter gradients equal to it exactly."""
    net = weights_(resnet.ResNet50(dtype), 5)
    x = image(2)
    before = resnet.fold_builds
    if mode == "inference_mode":
        with torch.inference_mode():
            out, ref = net(x), unfolded(net, x)
        for o, r in zip(out, ref):
            assert torch.equal(o, r)
    else:
        out = net(x)
        grads = torch.autograd.grad(sum(o.float().sum() for o in out),
                                    [p for p in net.parameters()
                                     if p.requires_grad])
        ref = unfolded(net, x)
        want = torch.autograd.grad(sum(r.float().sum() for r in ref),
                                   [p for p in net.parameters()
                                    if p.requires_grad])
        for o, r in zip(out, ref):
            assert torch.equal(o, r)
        for g, w in zip(grads, want):
            assert torch.equal(g, w)
    assert resnet.fold_builds == before
    assert tails == []


@pytest.mark.parametrize("change", ["load_state_dict", "conv_weight",
                                    "running_var", "stem_bias"])
def test_folded_weights_rebuilt_once_after_a_change(change):
    net = weights_(resnet.ResNet50(torch.bfloat16), 6)
    x = image(3)
    with torch.inference_mode():
        first = net(x)
        again = net(x)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    other = weights_(resnet.ResNet50(torch.bfloat16), 6)
    with torch.no_grad():
        if change == "load_state_dict":
            other = weights_(other, 7)
            net.load_state_dict(other.state_dict())
        else:
            for m in (net, other):
                if change == "conv_weight":
                    m.layer3[2].conv2.weight.mul_(-1.5)
                elif change == "running_var":
                    m.layer2[0].downsample[1].running_var.mul_(4.0)
                else:
                    m.bn1.bias.add_(0.5)
    before = resnet.fold_builds
    with torch.inference_mode():
        out = net(x)
        net(x)
        want = other(x)      # a fresh model with the changed weights
    assert resnet.fold_builds == before + 2     # net once, other once
    for o, w in zip(out, want):
        assert torch.equal(o, w)
    assert not torch.equal(out[-1], first[-1])


@pytest.mark.parametrize("first, second", [
    (torch.inference_mode, torch.no_grad),
    (torch.no_grad, torch.inference_mode)])
def test_folded_weights_shared_by_inference_mode_and_no_grad(first, second):
    net = weights_(resnet.ResNet50(torch.bfloat16), 8)
    x = image(4)
    with first():
        a = net(x)
    before = resnet.fold_builds
    with second():
        b = net(x)
    assert resnet.fold_builds == before
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("downsample", [True, False])
def test_block_folds_with_its_downsample_bias(downsample):
    """relu(conv3(x) + (b3 + bd) + convd(x)) is the unfolded block."""
    stride = 2 if downsample else 1
    block = resnet.Bottleneck(64 if downsample else 256, 64, stride,
                              downsample)
    weights_(block, 9)
    g = torch.Generator().manual_seed(10)
    x = torch.randn(2, block.conv1.in_channels, 12, 20, generator=g)
    with torch.no_grad():
        folded = block.fold()
        assert (folded[-1] is None) != downsample
        out, ref = block.forward_folded(x, folded), block(x)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("mode", [torch.inference_mode, torch.no_grad])
def test_export_holds_the_conv_tail_op(mode):
    """``torch.export`` of the bf16 backbone without a gradient (under
    ``no_grad`` as ``serving.export_streaming`` traces the step) carries
    each tail as one ``conv_tail`` node and folds in the graph; its program
    matches eager, and the export leaves the eager route's cache working."""
    net = weights_(resnet.ResNet50(torch.bfloat16), 11).eval()
    x = image(5)
    with mode():
        program = torch.export.export(net, (x,), strict=False)
    targets = [n.target for n in program.graph.nodes]
    assert targets.count(library.conv_tail) == 49
    with torch.inference_mode():
        got = program.module()(x)
        want = net(x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
