"""The small 2D vision models, layer for layer with the reference package's
flax definitions (its ``models/vision2d.py``): ``VGG`` (``vgg11``,
``vgg16``: biased 3x3 convs, each followed by GroupNorm(32) in float32),
the CIFAR CNNs ``CNNCifar`` and ``CNNCifarBN`` (its BatchNorm returns the
model's dtype, not float32), the FedAvg-paper CNNs ``CNN_OriginalFedAvg``
and ``CNN_DropOut`` (10 outputs with ``only_digits``, else 62), and
``LeNet5`` / ``LeNet5_cifar``.

flax sizes a dense layer from the input it meets, so these models take
28x28x1 and 32x32x3 images alike: the port sizes them from the input shape
``[H, W, C]`` (``[H, W]``: one channel) given at construction. Every
flatten before a dense layer is in the reference's NHWC order. The MNIST
family also takes ``[B, H, W]`` batches. ``CNN_DropOut``'s dropouts (0.25
on the pooled features, 0.5 after ``fc1``) take their keep-masks as an
input (``dropout_masks``, the first over the NHWC-flattened features) or
draw them from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch
import torch.nn.functional as F

from neuroimagedisttraining_tpu_torch.models.layers2d import (
    Conv2d, Module2D, flatten_last, in_channels,
)
from neuroimagedisttraining_tpu_torch.models.neuro3d import (
    BatchNorm3d, GroupNorm3d, Linear, _cast, _dropout, _f32,
)

VGG_CFG = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
}


def _spatial(shape) -> tuple[int, int]:
    return int(shape[0]), int(shape[1])


class VGG(Module2D):
    """VGG feature stack (``conv{i}``, ``gn{i}``, 2x2 max pools) and one
    dense ``classifier``."""

    def __init__(self, cfg: Sequence[Union[int, str]], num_classes: int = 10,
                 group_norm: bool = True, shape=(32, 32, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.group_norm, self.dtype = list(cfg), group_norm, dtype
        c, (h, w) = in_channels(shape), _spatial(shape)
        i = 0
        for v in self.cfg:
            if v == "M":
                h, w = h // 2, w // 2
                continue
            setattr(self, f"conv{i}", Conv2d(c, int(v), 3, 1, 1, dtype=dtype))
            if group_norm:
                setattr(self, f"gn{i}", GroupNorm3d(int(v)))
            c, i = int(v), i + 1
        self.classifier = Linear(c * h * w, num_classes, dtype)

    def forward(self, x, train: bool = False, dropout_masks=None,
                generator: torch.Generator | None = None):
        x = _cast(x, self.dtype)
        i = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = getattr(self, f"conv{i}")(x)
            if self.group_norm:
                x = getattr(self, f"gn{i}")(x, train)
            x = F.relu(x)
            i += 1
        return _f32(self.classifier(flatten_last(x)))


def vgg11(shape=(32, 32, 3), num_classes: int = 10,
          dtype=torch.float32) -> VGG:
    return VGG(VGG_CFG["A"], num_classes=num_classes, shape=shape,
               dtype=dtype)


def vgg16(shape=(32, 32, 3), num_classes: int = 10,
          dtype=torch.float32) -> VGG:
    return VGG(VGG_CFG["D"], num_classes=num_classes, shape=shape,
               dtype=dtype)


def _valid(n: int, k: int) -> int:
    return n - k + 1


class _TwoConvNet(Module2D):
    """Two (conv, [norm], ReLU, 2x2 max pool) stages and a dense head of
    ``widths`` (ReLU between) named ``names``: the shared shape of the
    CIFAR CNNs and LeNets."""

    def __init__(self, shape, channels: Sequence[int], kernel: int, pad: int,
                 widths: Sequence[int], names: Sequence[str],
                 batch_norm: bool, dtype: torch.dtype):
        super().__init__()
        self.dtype, self.names = dtype, list(names)
        c, (h, w) = in_channels(shape), _spatial(shape)
        self.conv1 = Conv2d(c, channels[0], kernel, 1, pad, dtype=dtype)
        self.conv2 = Conv2d(channels[0], channels[1], kernel, 1, pad,
                            dtype=dtype)
        self.batch_norm = batch_norm
        if batch_norm:
            self.bn1 = BatchNorm3d(channels[0], momentum=0.9, eps=1e-5,
                                   dtype=dtype)
            self.bn2 = BatchNorm3d(channels[1], momentum=0.9, eps=1e-5,
                                   dtype=dtype)
        for _ in range(2):
            h, w = _valid(h + 2 * pad, kernel) // 2, \
                _valid(w + 2 * pad, kernel) // 2
        width = channels[1] * h * w
        for name, out in zip(self.names, widths):
            setattr(self, name, Linear(width, out, dtype))
            width = out

    def features(self, x, train: bool):
        if x.dim() == 3:
            x = x.unsqueeze(1)
        x = _cast(x, self.dtype)
        for i in (1, 2):
            x = getattr(self, f"conv{i}")(x)
            if self.batch_norm:
                x = getattr(self, f"bn{i}")(x, train)
            x = F.max_pool2d(F.relu(x), 2, 2)
        return x

    def head(self, x):
        for name in self.names[:-1]:
            x = F.relu(getattr(self, name)(x))
        return _f32(getattr(self, self.names[-1])(x))

    def forward(self, x, train: bool = False, dropout_masks=None,
                generator: torch.Generator | None = None):
        return self.head(flatten_last(self.features(x, train)))


class CNNCifar(_TwoConvNet):
    """2 x (conv 5x5 64, ReLU, 2x2 max pool), dense 384 / 192 / classes."""

    def __init__(self, shape=(32, 32, 3), num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, batch_norm: bool = False):
        super().__init__(shape, (64, 64), 5, 0, (384, 192, num_classes),
                         ("fc1", "fc2", "fc3"), batch_norm, dtype)


class CNNCifarBN(CNNCifar):
    """CNNCifar with a BatchNorm (momentum 0.9, epsilon 1e-5, returning the
    model's dtype) after each conv."""

    def __init__(self, shape=(32, 32, 3), num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__(shape, num_classes, dtype, batch_norm=True)


class CNN_OriginalFedAvg(_TwoConvNet):
    """The FedAvg paper's MNIST CNN: conv 5x5 32 and 64 (padding 2), dense
    512 and 10 (``only_digits``) or 62."""

    def __init__(self, shape=(28, 28, 1), only_digits: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(shape, (32, 64), 5, 2,
                         (512, 10 if only_digits else 62), ("fc1", "fc2"),
                         False, dtype)


def cnn_dropout_flat(shape) -> int:
    """``CNN_DropOut``'s features at its first dropout for ``[H, W, C]``."""
    h, w = _spatial(shape)
    return 64 * math.prod(_valid(_valid(n, 3), 3) // 2 for n in (h, w))


class CNN_DropOut(Module2D):
    """The Adaptive Federated Optimization EMNIST CNN: conv 3x3 32, conv
    3x3 64, a 2x2 max pool, dropout 0.25, dense 128, dropout 0.5, dense 10
    (``only_digits``) or 62."""

    def __init__(self, shape=(28, 28, 1), only_digits: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(in_channels(shape), 32, 3, dtype=dtype)
        self.conv2 = Conv2d(32, 64, 3, dtype=dtype)
        self.fc1 = Linear(cnn_dropout_flat(shape), 128, dtype)
        self.fc2 = Linear(128, 10 if only_digits else 62, dtype)

    def forward(self, x, train: bool = False, dropout_masks=None,
                generator: torch.Generator | None = None):
        if x.dim() == 3:
            x = x.unsqueeze(1)
        x = _cast(x, self.dtype)
        x = F.relu(self.conv2(F.relu(self.conv1(x))))
        x = flatten_last(F.max_pool2d(x, 2, 2))
        if train:
            x = _dropout(x, 0, dropout_masks, generator, rate=0.25)
        x = F.relu(self.fc1(x))
        if train:
            x = _dropout(x, 1, dropout_masks, generator, rate=0.5)
        return _f32(self.fc2(x))


class LeNet5(_TwoConvNet):
    """Caffe LeNet-5: conv 5x5 20 and 50 (no padding), dense ``fc3`` 500
    and ``fc4``."""

    def __init__(self, shape=(28, 28, 1), num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__(shape, (20, 50), 5, 0, (500, num_classes),
                         ("fc3", "fc4"), False, dtype)


class LeNet5_cifar(_TwoConvNet):
    """CIFAR LeNet: conv 5x5 6 and 16, dense 120 / 84 / classes."""

    def __init__(self, shape=(32, 32, 3), num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__(shape, (6, 16), 5, 0, (120, 84, num_classes),
                         ("fc1", "fc2", "fc3"), False, dtype)
