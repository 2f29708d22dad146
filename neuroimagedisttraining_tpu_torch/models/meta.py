"""The mask-parameterized "meta" models, layer for layer with the reference
package's flax definitions (its ``models/meta.py``):

- ``CNNCifarMeta`` (``cnn_meta``): a bias-free CIFAR CNN whose two 5x5
  conv kernels and dense kernel are top-level parameters
  (``meta_conv1_weight``, ``meta_conv2_weight``, ``meta_fc1_weight``; the
  reference's ``meta_conv1_kernel`` ...), each optionally multiplied by a
  binary mask given to the forward (``masks``, keyed ``meta_conv1`` ...,
  in the port's layouts). Its logits keep the model's dtype, as the
  reference's.
- ``MetaNet``: a hypernetwork MLP mapping a mask to a weight of the same
  shape (the flat order is the reference's layout).
- ``SlimBottleneckMeta`` and ``ResNetMeta`` (``resnet_meta``): a
  width-slimmable ResNet whose conv kernels are generated on every forward
  by a small MLP of the width scales (``*_fc1`` -> 32 -> ReLU -> ``*_fc2``,
  in the reference's HWIO order, then laid out OIHW). Those dense layers,
  not the generated kernels, are the model's parameters: they are masked
  and stepped. Channels past ``round(max * scale)`` are masked to zero.
  Its convolutions and its stem's 3x3/2 max pool pad as XLA's ``"SAME"``
  (a stride-2 window on an even input: nothing before, one after; the
  pool pads with -inf), its BatchNorms have no scale or bias, flax's
  default momentum 0.99 and epsilon 1e-5, and compute in the model's
  dtype. ``stage_ids`` / ``mid_ids`` index ``CHANNEL_SCALE``; full width
  by default.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from neuroimagedisttraining_tpu_torch.models.layers2d import (
    KernelConv2d, Module2D, flatten_last, he_uniform_, in_channels,
    max_pool2d,
)
from neuroimagedisttraining_tpu_torch.models.neuro3d import (
    BatchNorm3d, Linear, _cast, _f32,
)

#: the 31 width multipliers 0.10 .. 1.00 in steps of 0.03
CHANNEL_SCALE = tuple((10 + i * 3) / 100 for i in range(31))


def _valid(n: int, k: int, s: int = 1) -> int:
    return (n - k) // s + 1


class CNNCifarMeta(Module2D):
    """conv 5x5 64 -> ReLU -> 3x3/2 max pool, twice, then a dense kernel to
    the classes; no biases."""

    def __init__(self, shape=(32, 32, 3), num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        c = in_channels(shape)
        h, w = (_valid(_valid(_valid(_valid(n, 5), 3, 2), 5), 3, 2)
                for n in shape[:2])
        self.meta_conv1_weight = nn.Parameter(torch.empty(64, c, 5, 5))
        self.meta_conv2_weight = nn.Parameter(torch.empty(64, 64, 5, 5))
        self.meta_fc1_weight = nn.Parameter(torch.empty(num_classes,
                                                        64 * h * w))
        self.meta_conv1 = KernelConv2d(dtype=dtype)
        self.meta_conv2 = KernelConv2d(dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.meta_conv1_weight, self.meta_conv2_weight):
            he_uniform_(w, w[0].numel(), generator)
        he_uniform_(self.meta_fc1_weight, self.meta_fc1_weight.shape[1],
                    generator)

    def _masked(self, name: str, masks):
        w = _cast(getattr(self, f"{name}_weight"), self.dtype)
        if masks is not None and name in masks:
            w = w * _cast(masks[name], w.dtype)
        return w

    def forward(self, x, train: bool = False, dropout_masks=None,
                generator: torch.Generator | None = None, masks=None):
        for name in ("meta_conv1", "meta_conv2"):
            x = getattr(self, name)(x, self._masked(name, masks))
            x = F.max_pool2d(F.relu(x), 3, 2)
        return flatten_last(x) @ self._masked("meta_fc1", masks).t()


class MetaNet(nn.Module):
    """mask -> flatten -> dense 50 -> ReLU -> dense 50 -> ReLU -> dense
    ``size`` -> a weight of the mask's shape; dense layers ``Dense_0..2``
    with flax's he_uniform kernels. The mask is flattened, and the weight
    laid out, in the reference's order (``ops.masks.reference_flat``)."""

    def __init__(self, size: int, hidden: int = 50,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = Linear(size, hidden, dtype)
        self.Dense_1 = Linear(hidden, hidden, dtype)
        self.Dense_2 = Linear(hidden, size, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for d in (self.Dense_0, self.Dense_1, self.Dense_2):
            he_uniform_(d.weight, d.weight.shape[1], generator)
            nn.init.zeros_(d.bias)

    def forward(self, mask: torch.Tensor) -> torch.Tensor:
        from neuroimagedisttraining_tpu_torch.ops.masks import (
            from_reference_flat, reference_flat,
        )

        x = F.relu(self.Dense_0(_cast(reference_flat(mask), self.dtype)))
        w = self.Dense_2(F.relu(self.Dense_1(x)))
        return from_reference_flat(w, mask)


class HyperKernel:
    """A conv kernel generated from the width scales: ``fc1`` (32) ->
    ReLU -> ``fc2`` (the kernel's size), reshaped to the reference's HWIO
    ``shape`` and laid out OIHW. Its two dense layers are the owning
    module's ``{name}_fc1`` / ``{name}_fc2``."""

    def __init__(self, owner: nn.Module, name: str, n_scales: int,
                 shape: tuple[int, int, int, int], dtype: torch.dtype,
                 hidden: int = 32):
        self.shape, self.dtype = shape, dtype
        self.fc1_name, self.fc2_name = f"{name}_fc1", f"{name}_fc2"
        setattr(owner, self.fc1_name, Linear(n_scales, hidden, dtype))
        setattr(owner, self.fc2_name, Linear(hidden, math.prod(shape), dtype))

    def generate(self, owner: nn.Module, scales: torch.Tensor) -> torch.Tensor:
        h = getattr(owner, self.fc1_name)(_cast(scales, self.dtype))
        w = getattr(owner, self.fc2_name)(F.relu(h))
        return w.reshape(self.shape).permute(3, 2, 0, 1)


def width_mask(max_ch: int, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Ones on the first ``round(max_ch * scale)`` channels (half to even,
    the product in ``dtype``), zeros past them."""
    active = torch.round(max_ch * _cast(scale, dtype)).to(torch.int32)
    return (torch.arange(max_ch, device=scale.device) < active).to(dtype)


def _bn(features: int, dtype) -> BatchNorm3d:
    """flax's default BatchNorm without scale or bias, in ``dtype``."""
    return BatchNorm3d(features, momentum=0.99, eps=1e-5, dtype=dtype,
                       affine=False)


def _masked_kernel(k, mask_in, mask_out):
    """An OIHW kernel with its input and output channels masked."""
    return k * mask_in[None, :, None, None] * mask_out[:, None, None, None]


class SlimBottleneckMeta(nn.Module):
    """Width-slimmable bottleneck with generated kernels: 1x1 reduce (to a
    quarter of ``max_oup``) -> 3x3 (``stride``) -> 1x1 expand, each from the
    (mid, inp, oup) scales, plus a generated 1x1 projection ``conv_ds`` /
    ``bn_ds`` with ``is_downsample``."""

    def __init__(self, max_inp: int, max_oup: int, stride: int = 1,
                 is_downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_inp, self.max_oup = max_inp, max_oup
        self.max_mid = max_oup // 4
        self.dtype, self.is_downsample = dtype, is_downsample
        mid = self.max_mid
        shapes = {"conv1": ((1, 1, max_inp, mid), 1),
                  "conv2": ((3, 3, mid, mid), stride),
                  "conv3": ((1, 1, mid, max_oup), 1)}
        if is_downsample:
            shapes["conv_ds"] = ((1, 1, max_inp, max_oup), stride)
        self.kernels = {}
        for name, (shape, s) in shapes.items():
            self.kernels[name] = HyperKernel(self, name, 3, shape, dtype)
            setattr(self, f"{name}_op", KernelConv2d(
                s, same=True, dtype=dtype,
                kernel_shape=(shape[3], shape[2], shape[0], shape[1])))
        self.bn1, self.bn2 = _bn(mid, dtype), _bn(mid, dtype)
        self.bn3 = _bn(max_oup, dtype)
        if is_downsample:
            self.bn_ds = _bn(max_oup, dtype)

    def _conv(self, name, h, scales, mask_in, mask_out):
        k = self.kernels[name].generate(self, scales)
        return getattr(self, f"{name}_op")(h, _masked_kernel(k, mask_in,
                                                              mask_out))

    def forward(self, x, scales: torch.Tensor, train: bool):
        dt = self.dtype
        m_inp = width_mask(self.max_inp, scales[1], dt)
        m_mid = width_mask(self.max_mid, scales[0], dt)
        m_oup = width_mask(self.max_oup, scales[2], dt)
        view = (1, -1, 1, 1)
        out = self._conv("conv1", x, scales, m_inp, m_mid)
        out = F.relu(self.bn1(out, train) * m_mid.view(view))
        out = self._conv("conv2", out, scales, m_mid, m_mid)
        out = F.relu(self.bn2(out, train) * m_mid.view(view))
        out = self._conv("conv3", out, scales, m_mid, m_oup)
        out = self.bn3(out, train) * m_oup.view(view)
        identity = x
        if self.is_downsample:
            identity = self._conv("conv_ds", x, scales, m_inp, m_oup)
            identity = self.bn_ds(identity, train) * m_oup.view(view)
        return F.relu(out + identity)


class ResNetMeta(Module2D):
    """Slimmable hypernetwork ResNet: a generated 7x7 stem (``stem_fc1`` /
    ``stem_fc2``) masked to the stem's width, ``stem_bn``, ReLU, a 3x3/2
    ``"SAME"`` max pool, bottlenecks ``block{0,1,2}`` over 16 -> 32 -> 64
    -> 64 channels (strides 1, 2, 2), the global mean and ``fc``. Float32
    logits."""

    def __init__(self, shape=(32, 32, 3), num_classes: int = 10,
                 stage_planes: tuple = (16, 32, 64, 64),
                 stage_strides: tuple = (1, 1, 2, 2),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.stage_planes = dtype, tuple(stage_planes)
        c0 = stage_planes[0]
        self.stem = HyperKernel(self, "stem", 1, (7, 7, in_channels(shape),
                                                  c0), dtype)
        self.stem_op = KernelConv2d(1, same=True, dtype=dtype,
                                    kernel_shape=(c0, in_channels(shape), 7,
                                                  7))
        self.stem_bn = _bn(c0, dtype)
        self.n_blocks = len(stage_planes) - 1
        for b in range(self.n_blocks):
            setattr(self, f"block{b}", SlimBottleneckMeta(
                stage_planes[b], stage_planes[b + 1], stage_strides[b + 1],
                is_downsample=True, dtype=dtype))
        self.fc = Linear(stage_planes[-1], num_classes, dtype)
        self._tables: dict = {}

    def scale_table(self, device: torch.device) -> torch.Tensor:
        """``CHANNEL_SCALE`` in the model's dtype on ``device`` (copied
        there once)."""
        if device not in self._tables:
            self._tables[device] = torch.tensor(CHANNEL_SCALE,
                                                dtype=self.dtype,
                                                device=device)
        return self._tables[device]

    def forward(self, x, train: bool = False, dropout_masks=None,
                generator: torch.Generator | None = None, stage_ids=None,
                mid_ids=None):
        dt, n = self.dtype, self.n_blocks
        full = len(CHANNEL_SCALE) - 1
        if stage_ids is None:
            stage_ids = [full] * (n + 1)
        if mid_ids is None:
            mid_ids = [full] * n
        table = self.scale_table(x.device)
        stem_s = table[stage_ids[0]]
        m0 = width_mask(self.stage_planes[0], stem_s, dt)
        k0 = self.stem.generate(self, stem_s[None]) * m0[:, None, None, None]
        h = self.stem_bn(self.stem_op(_cast(x, dt), k0), train)
        h = max_pool2d(F.relu(h) * m0.view(1, -1, 1, 1), 3, 2, same=True)
        for b in range(n):
            scales = torch.stack([table[mid_ids[b]], table[stage_ids[b]],
                                  table[stage_ids[b + 1]]])
            h = getattr(self, f"block{b}")(h, scales, train)
        return _f32(self.fc(h.mean((2, 3))))
