"""The layers of the 2D zoo (``resnet2d.py``, ``vision2d.py``, ``meta.py``),
with the 3D family's conventions (``neuro3d.py``): tensors NCHW inside
(the trainer turns the data's NHWC images into NCHW), parameters float32
and cast to the layer's compute ``dtype`` on every forward, normalisation
statistics in float32 as flax takes them, and a dense layer fed the
reference's channels-last feature order (:func:`flatten_last`).

- ``Conv2d``: a conv weight OIHW with an optional bias, padded
  symmetrically (``pad``) or as XLA's ``"SAME"`` (``same=True``: for a
  stride-2 kernel on an even input nothing before and one after); kernel,
  stride and padding square or ``(H, W)`` pairs, with ``dilation`` and
  ``groups`` (depthwise: ``groups = c_in``) as DARTS' convolutions take
  them.
- ``KernelConv2d``: the same convolution with its kernel handed in (a
  parameter held elsewhere, or one a hypernetwork generates); it records
  the generated kernel's shape for the FLOP counter.
- The norms are ``neuro3d``'s ``BatchNorm3d`` / ``GroupNorm3d``, which
  take any rank.
- ``max_pool2d``: floor windows, or ``"SAME"`` windows padded with -inf.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from neuroimagedisttraining_tpu_torch.models.neuro3d import (
    _cast, _Module3D, lecun_normal_,
)



class Module2D(_Module3D):
    """What every 2D model shares: its init, compute dtype, and an input
    of rank 4 (batch, channel, H, W)."""

    input_rank = 4


def in_channels(shape) -> int:
    """The channels of ``[H, W, C]`` images (1 for ``[H, W]``)."""
    return shape[2] if len(shape) == 3 else 1


def he_uniform_(w: torch.Tensor, fan_in: int,
                generator: torch.Generator) -> None:
    """flax's ``he_uniform``: U(-sqrt(6 / fan_in), sqrt(6 / fan_in))."""
    lim = math.sqrt(6.0 / fan_in)
    with torch.no_grad():
        w.uniform_(-lim, lim, generator=generator)


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one dim: ``(before, after)``, the odd
    one after."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    (t, b), (l, r) = (same_pads(n, k, s) for n in x.shape[-2:])
    if t == b and l == r:
        return x, t
    return F.pad(x, (l, r, t, b), value=value), 0


def conv2d(x, w, b, stride, pad, same: bool, dtype, dilation: int = 1,
           groups: int = 1):
    """``conv2d`` in ``dtype`` (input, kernel and bias cast to it), padded
    by ``pad`` on each side or as XLA's ``"SAME"``."""
    x, w, b = _cast(x, dtype), _cast(w, dtype), _cast(b, dtype)
    if same:
        x, pad = _same_pad(x, w.shape[-1], stride)
    return F.conv2d(x, w, b, stride=stride, padding=pad, dilation=dilation,
                    groups=groups)


def max_pool2d(x: torch.Tensor, k: int, s: int,
               same: bool = False) -> torch.Tensor:
    """Max pool with floor windows, or ``"SAME"`` windows padded with
    -inf."""
    pad = 0
    if same:
        x, pad = _same_pad(x, k, s, value=float("-inf"))
    return F.max_pool2d(x, k, s, padding=pad)


def flatten_last(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, H*W*C] in the reference's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _pair(v) -> tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class Conv2d(nn.Module):
    """A 2D convolution: ``weight`` [c_out, c_in / groups, kh, kw] (flax's
    lecun_normal init) and ``bias`` (none with ``bias=False``)."""

    def __init__(self, c_in: int, c_out: int, kernel, stride=1, pad=0,
                 bias: bool = True, same: bool = False,
                 dtype: torch.dtype = torch.float32, dilation: int = 1,
                 groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in // groups,
                                               *_pair(kernel)))
        if bias:
            self.bias = nn.Parameter(torch.empty(c_out))
        else:
            self.register_parameter("bias", None)
        self.stride, self.pad, self.same = stride, pad, same
        self.dtype, self.dilation, self.groups = dtype, dilation, groups

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.pad,
                      self.same, self.dtype, self.dilation, self.groups)


class KernelConv2d(nn.Module):
    """A bias-free 2D convolution whose OIHW kernel is an argument.
    ``kernel_shape``, where given, is a generated kernel's shape: the FLOP
    counter counts it at this module's output (a kernel that is a
    parameter is counted through the parameter)."""

    def __init__(self, stride: int = 1, same: bool = False,
                 dtype: torch.dtype = torch.float32,
                 kernel_shape: tuple[int, ...] | None = None):
        super().__init__()
        self.stride, self.same, self.dtype = stride, same, dtype
        self.kernel_shape = kernel_shape

    def forward(self, x, w):
        return conv2d(x, w, None, self.stride, 0, self.same, self.dtype)
