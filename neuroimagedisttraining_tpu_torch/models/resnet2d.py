"""The 2D ResNet-18 family for CIFAR and TinyImageNet, layer for layer with
the reference package's flax definitions (its ``models/resnet2d.py``):
``ResNet(BasicBlock, [2, 2, 2, 2])`` with a 3x3 stem and no stem max pool.
``customized_resnet18`` (``--model resnet18``) has GroupNorm(32) in every
norm, ``original_resnet18`` BatchNorm, ``tiny_resnet18`` GroupNorm and a
global average pool for 64x64 inputs, and ``resnet18_ip`` the per-batch
"ipbn" norm. Module names are flax's (``layer2_0.sc_conv``,
``bn1.norm``), so ``weights.py`` carries a tree across leaf by leaf.

The norms compute in float32 and return float32 whatever the model's dtype
(flax's ``_Norm`` takes its default dtype), except ``ipbn``, which returns
its input's dtype.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from neuroimagedisttraining_tpu_torch.models.layers2d import (
    Conv2d, Module2D, flatten_last, in_channels,
)
from neuroimagedisttraining_tpu_torch.models.neuro3d import (
    BatchNorm3d, GroupNorm3d, Linear, _cast, _f32,
)


class IPNorm(nn.Module):
    """The "independent personalization" norm (``ipbn``): every forward,
    training or evaluation, normalizes by the batch's own mean and variance
    (``mean((x - mean)^2)``, epsilon 1e-5), in float32; a learned scale and
    bias and no running stats. Returns its input's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x, train: bool):
        xf = _f32(x)
        dims = (0, 2, 3)
        mean = xf.mean(dims, keepdim=True)
        var = ((xf - mean) ** 2).mean(dims, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + 1e-5)
        view = (1, -1, 1, 1)
        return _cast(y * self.weight.view(view) + self.bias.view(view),
                     x.dtype)


class Norm(nn.Module):
    """flax's ``_Norm``: ``bn`` (BatchNorm, momentum 0.9, epsilon 1e-5) or
    ``gn`` (GroupNorm(32), epsilon 1e-6) as the submodule ``norm``, both
    float32; ``ipbn`` is :class:`IPNorm` itself."""

    def __init__(self, kind: str, features: int):
        super().__init__()
        if kind == "bn":
            self.norm = BatchNorm3d(features, momentum=0.9, eps=1e-5)
        elif kind == "gn":
            self.norm = GroupNorm3d(features)
        else:
            raise ValueError(f"unknown norm {kind!r}")

    def forward(self, x, train: bool):
        return self.norm(x, train)


def make_norm(kind: str, features: int) -> nn.Module:
    return IPNorm(features) if kind == "ipbn" else Norm(kind, features)


class BasicBlock2D(nn.Module):
    """Two 3x3 bias-free convs with their norms, and a 1x1 strided
    projection ``sc_conv`` / ``sc_bn`` where the stride or width
    changes."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 norm: str = "bn", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False,
                            dtype=dtype)
        self.bn1 = make_norm(norm, planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False, dtype=dtype)
        self.bn2 = make_norm(norm, planes)
        self.shortcut = stride != 1 or inplanes != planes
        if self.shortcut:
            self.sc_conv = Conv2d(inplanes, planes, 1, stride, 0, bias=False,
                                  dtype=dtype)
            self.sc_bn = make_norm(norm, planes)

    def forward(self, x, train: bool):
        out = F.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        if self.shortcut:
            x = self.sc_bn(self.sc_conv(x), train)
        return F.relu(out + x)


def resnet18_flat_features(shape: Sequence[int],
                           adaptive_pool: bool = False) -> int:
    """The input width of ``linear`` for ``[H, W, C]`` images: 512 channels
    times the positions after three stride-2 stages and the 4x4 average
    pool (none with the global pool)."""
    if adaptive_pool:
        return 512
    def out(n):
        for _ in range(3):
            n = (n - 1) // 2 + 1
        return n // 4
    return 512 * math.prod(out(n) for n in shape[:2])


class ResNet18(Module2D):
    """CIFAR-style ResNet-18: ``conv1`` (3x3) and ``bn1``, stages
    ``layer{1..4}_{0,1}`` of 64 / 128 / 256 / 512 planes (strides 1, 2, 2,
    2), a 4x4 average pool (the global mean with ``adaptive_pool``) and
    ``linear``. Float32 logits."""

    def __init__(self, num_classes: int = 10, norm: str = "bn",
                 num_blocks: Sequence[int] = (2, 2, 2, 2),
                 adaptive_pool: bool = False, flat_features: int = 512,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.adaptive_pool = adaptive_pool
        #: ``ipbn`` normalises by the batch in evaluation too
        self.eval_batch_stats = norm == "ipbn"
        self.conv1 = Conv2d(in_channels, 64, 3, 1, 1, bias=False, dtype=dtype)
        self.bn1 = make_norm(norm, 64)
        self.blocks = []
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                     num_blocks)):
            for i in range(blocks):
                s = (1 if stage == 0 else 2) if i == 0 else 1
                name = f"layer{stage + 1}_{i}"
                setattr(self, name, BasicBlock2D(inplanes, planes, s, norm,
                                                 dtype))
                self.blocks.append(name)
                inplanes = planes
        self.linear = Linear(flat_features, num_classes, dtype)

    def forward(self, x, train: bool = False, dropout_masks=None,
                generator: torch.Generator | None = None):
        x = _cast(x, self.dtype)
        x = F.relu(self.bn1(self.conv1(x), train))
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        if self.adaptive_pool:
            x = x.mean((2, 3))
        else:
            x = flatten_last(F.avg_pool2d(x, 4, 4))
        return _f32(self.linear(x))


def _resnet18(shape, num_classes, norm, dtype, adaptive_pool=False):
    return ResNet18(num_classes=num_classes, norm=norm,
                    adaptive_pool=adaptive_pool,
                    flat_features=resnet18_flat_features(shape,
                                                         adaptive_pool),
                    in_channels=in_channels(shape),
                    dtype=dtype)


def customized_resnet18(shape=(32, 32, 3), num_classes: int = 10,
                        dtype=torch.float32) -> ResNet18:
    """GroupNorm ResNet-18 for ``[H, W, C]`` images."""
    return _resnet18(shape, num_classes, "gn", dtype)


def original_resnet18(shape=(32, 32, 3), num_classes: int = 10,
                      dtype=torch.float32) -> ResNet18:
    """BatchNorm ResNet-18."""
    return _resnet18(shape, num_classes, "bn", dtype)


def tiny_resnet18(shape=(64, 64, 3), num_classes: int = 10,
                  dtype=torch.float32) -> ResNet18:
    """GroupNorm ResNet-18 with the global average pool."""
    return _resnet18(shape, num_classes, "gn", dtype, adaptive_pool=True)


def resnet18_ip(shape=(32, 32, 3), num_classes: int = 10,
                dtype=torch.float32) -> ResNet18:
    """ResNet-18 with the per-batch ``ipbn`` norms."""
    return _resnet18(shape, num_classes, "ipbn", dtype)
