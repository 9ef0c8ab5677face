"""ResNet-50 backbone with frozen BatchNorm (counterpart of
``memotr_tpu/models/resnet.py``).

torchvision-style ResNet-50 v1.5 (stride on each bottleneck's 3x3 conv)
written in the repo, with torchvision's parameter names, returning the
layer2/3/4 maps at strides 8/16/32.  Convolutions run NCHW in the compute
dtype; parameters and the frozen statistics stay float32.  The stem and
``layer1`` never train: their parameters are made with
``requires_grad=False``, as the reference MeMOTR's backbone does (the JAX
trainer's "frozen" group).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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

    def forward(self, x: torch.Tensor):
        x = F.relu(self.bn1(self.conv1(x)))
        # max-pool pads with -inf (F.max_pool2d's implicit padding)
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer1(x)
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        c5 = self.layer4(c4)
        return c3, c4, c5
