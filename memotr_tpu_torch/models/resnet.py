"""ResNet-50 backbone with frozen BatchNorm (counterpart of
``memotr_tpu/models/resnet.py``).

torchvision-style ResNet-50 v1.5 (stride on each bottleneck's 3x3 conv)
written in the repo, with torchvision's parameter names, returning the
layer2/3/4 maps at strides 8/16/32.  Convolutions run NCHW in the compute
dtype; parameters and the frozen statistics stay float32.  The stem and
``layer1`` never train: their parameters are made with
``requires_grad=False``, as the reference MeMOTR's backbone does (the JAX
trainer's "frozen" group).

Two routes, chosen in ``ResNet50.forward`` from what the call shows:

- without a gradient and in bfloat16 (streaming, evaluation, the exported
  step, a distillation teacher), the folded route: each frozen BatchNorm is
  folded into the convolution before it (``fold``), once per weight set,
  and each convolution ends in one ``conv_tail`` op (``ops/library.py``),
  which adds the folded bias, the block's identity where there is one, and
  applies the ReLU, in place.  The downsample branch's bias joins its
  block's last bias, so the branch is a bare convolution;
- otherwise (training, float32 models) the route of the JAX package:
  convolution, then the BatchNorm's affine in the compute dtype, residual
  and ReLU, each a pass of its own, with gradients through them.

``fold_builds`` counts the times a backbone's folded weights were built.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import library

fold_builds = 0


class FrozenBatchNorm2d(nn.Module):
    """Per-channel affine with frozen statistics, held as buffers."""

    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(n))
        self.register_buffer("bias", torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        # scale and shift are cast to the activation dtype, as in JAX
        return (x * scale.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs in ``compute_dtype`` with float32 parameters."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, self.dilation, self.groups)

    def with_weight(self, x: torch.Tensor,
                    weight: torch.Tensor) -> torch.Tensor:
        """This convolution's geometry on ``x`` with ``weight``, no bias."""
        return F.conv2d(x, weight, None, self.stride, self.padding,
                        self.dilation, self.groups)


def fold(conv: Conv2d, bn: FrozenBatchNorm2d
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``conv`` followed by ``bn`` as one convolution -> (weight in the
    conv's compute dtype and channels_last, bias float32), computed in
    float32 from the float32 parameters and statistics."""
    scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    weight = (conv.weight * scale[:, None, None, None]).to(
        conv.compute_dtype, memory_format=torch.channels_last)
    return weight, bn.bias - bn.running_mean * scale


def conv_tail(conv: Conv2d, x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor,
              identity: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(conv(x; weight) + bias (+ identity)): ``conv``'s geometry with
    folded weights, no bias in the convolution, one tail op after it."""
    y = conv.with_weight(x, weight)
    library.conv_tail(y, bias, identity, True)
    return y


class _FoldCache:
    """A backbone's folded weights and the stamps of their sources (each
    convolution's weight and its BatchNorm's buffers, read through their
    modules' dicts at every call, cheaply).  An object of its own, so that
    tracers, which swap the tensors they find in a module's attributes,
    leave it alone."""

    def __init__(self, pairs: List[Tuple[Conv2d, FrozenBatchNorm2d]]):
        self.sources = [(c._parameters, "weight") for c, _ in pairs] + [
            (bn._buffers, k) for _, bn in pairs
            for k in ("weight", "bias", "running_mean", "running_var")]
        self.stamps = None
        self.folded = None

    def current(self) -> List[Tuple[int, int]]:
        """Each source's ``data_ptr`` and version counter: they change when
        it is replaced, moved or written in place."""
        tensors = [d[k] for d, k in self.sources]
        try:
            return [(t.data_ptr(), t._version) for t in tensors]
        except RuntimeError:        # an inference tensor keeps no count
            return [(t.data_ptr(), 0 if t.is_inference() else t._version)
                    for t in tensors]


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False, compute_dtype=dtype)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1,
                            bias=False, compute_dtype=dtype)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False, compute_dtype=dtype)
        self.bn3 = FrozenBatchNorm2d(out)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, out, 1, stride=stride, bias=False,
                       compute_dtype=dtype),
                FrozenBatchNorm2d(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)

    def pairs(self) -> List[Tuple[Conv2d, FrozenBatchNorm2d]]:
        """Each convolution with its BatchNorm, the downsample's last."""
        out = [(self.conv1, self.bn1), (self.conv2, self.bn2),
               (self.conv3, self.bn3)]
        if self.downsample is not None:
            out.append((self.downsample[0], self.downsample[1]))
        return out

    def fold(self) -> Tuple[torch.Tensor, ...]:
        """(w1, b1, w2, b2, w3, b3, wd): folded weights and biases, the
        downsample's bias added to b3 (wd None without a downsample)."""
        (w1, b1), (w2, b2), (w3, b3), *ds = [fold(c, bn)
                                            for c, bn in self.pairs()]
        wd = None
        if ds:
            wd, bd = ds[0]
            b3 = b3 + bd
        return w1, b1, w2, b2, w3, b3, wd

    def forward_folded(self, x: torch.Tensor,
                       folded: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        """The block on weights from ``fold``: three convolutions with a
        tail each, the downsample a bare convolution read as identity."""
        w1, b1, w2, b2, w3, b3, wd = folded
        out = conv_tail(self.conv1, x, w1, b1)
        out = conv_tail(self.conv2, out, w2, b2)
        identity = x if wd is None else \
            self.downsample[0].with_weight(x, wd)
        return conv_tail(self.conv3, out, w3, b3, identity)


class ResNet50(nn.Module):
    """NCHW in; (layer2, layer3, layer4) NCHW maps out."""
    num_channels = (512, 1024, 2048)

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            compute_dtype=dtype)
        self.bn1 = FrozenBatchNorm2d(64)
        inplanes = 64
        for i, (planes, blocks, stride) in enumerate(
                ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)), start=1):
            layer = [Bottleneck(inplanes, planes, stride, True, dtype)]
            inplanes = planes * Bottleneck.expansion
            layer += [Bottleneck(inplanes, planes, dtype=dtype)
                      for _ in range(1, blocks)]
            setattr(self, f"layer{i}", nn.Sequential(*layer))
        for p in (*self.conv1.parameters(), *self.layer1.parameters()):
            p.requires_grad_(False)
        self._fold_cache = _FoldCache([(self.conv1, self.bn1)] + [
            p for layer in self.layers() for b in layer for p in b.pairs()])

    def layers(self) -> Tuple[nn.Sequential, ...]:
        return self.layer1, self.layer2, self.layer3, self.layer4

    def _fold(self):
        return fold(self.conv1, self.bn1), [[b.fold() for b in layer]
                                            for layer in self.layers()]

    def folded(self):
        """(stem (weight, bias), each layer's list of ``Bottleneck.fold``
        results), built again only when a source tensor (a convolution's
        weight, a BatchNorm buffer) was replaced, moved or written in place
        since the last build (``load_state_dict``, an optimizer step, an
        in-place edit).  Under a tracer (``torch.export``) the weights are
        folded in the graph, from the traced parameters."""
        global fold_builds
        if torch.compiler.is_compiling():
            return self._fold()
        cache = self._fold_cache
        stamps = cache.current()
        if stamps != cache.stamps:
            cache.folded, cache.stamps = self._fold(), stamps
            fold_builds += 1
        return cache.folded

    def forward(self, x: torch.Tensor):
        if not torch.is_grad_enabled() and \
                self.conv1.compute_dtype == torch.bfloat16:
            return self.forward_folded(x)
        x = F.relu(self.bn1(self.conv1(x)))
        # max-pool pads with -inf (F.max_pool2d's implicit padding)
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer1(x)
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        c5 = self.layer4(c4)
        return c3, c4, c5

    def forward_folded(self, x: torch.Tensor):
        """The inference route, in any compute dtype: channels_last maps
        through folded convolutions and ``conv_tail`` ops (49 of them:
        the stem and three a block)."""
        (w, b), layers = self.folded()
        x = x.to(self.conv1.compute_dtype, memory_format=torch.channels_last)
        x = F.max_pool2d(conv_tail(self.conv1, x, w, b), 3, stride=2,
                         padding=1)
        feats = []
        for layer, folded in zip(self.layers(), layers):
            for block, f in zip(layer, folded):
                x = block.forward_folded(x, f)
            feats.append(x)
        return tuple(feats[1:])
