"""AlexNet3D_Dropout, the flagship ABCD model (``--model 3DCNN``), layer for
layer with the reference package's flax definition.

- Tensors are NCDHW inside (cuDNN's native layout). Before the flatten the
  features are permuted to channels-last, so ``fc1`` sees the reference's
  NDHWC feature order and a carried-across ``fc1`` kernel needs no row
  permutation.
- BatchNorm follows flax, not ``torch.nn.BatchNorm3d``: statistics are
  ``E[x]`` and ``E[x^2] - E[x]^2`` (clipped at 0), the running variance is
  updated with this biased variance, and running stats move by
  ``0.9 * old + 0.1 * new``. In training mode the running stats are written
  in place into the module's buffers (the trainer hands in copies).
- Dropout takes its keep-masks as an input (``dropout_masks``) or draws
  them from an explicit ``torch.Generator``; kept units are scaled by 2.
- Pooling is ``max_pool3d(3, 3)`` with floor semantics (VALID windows).
- With ``fast_stem`` the stem runs through ``ops.stemconv.stem_conv3d``
  (the hand-written weight gradient); the parameters are the same.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from neuroimagedisttraining_tpu_torch.ops.stemconv import stem_conv3d

#: flax's lecun_normal: truncated normal on [-2, 2] std, rescaled so the
#: truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


class Conv3d(nn.Module):
    """A 3D convolution: ``weight`` OIDHW, ``bias``; ``fast_stem`` takes
    the stride-2 5^3 single-channel stem through ``ops.stemconv``."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 pad: int = 0, fast_stem: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel, kernel,
                                               kernel))
        self.bias = nn.Parameter(torch.empty(c_out))
        self.stride, self.pad = stride, pad
        self.fast_stem = fast_stem

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        if self.fast_stem:
            return (stem_conv3d(x, self.weight)
                    + self.bias.view(1, -1, 1, 1, 1))
        return F.conv3d(x, self.weight, self.bias, stride=self.stride,
                        padding=self.pad)


class Linear(nn.Module):
    """Parameters of a dense layer: ``weight`` [out, in], ``bias``."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in))
        self.bias = nn.Parameter(torch.empty(c_out))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class BatchNorm3d(nn.Module):
    """BatchNorm with flax's statistics and momentum (see module doc)."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x, train: bool):
        view = (1, -1, 1, 1, 1)
        if train:
            dims = (0, 2, 3, 4)
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(view)) * mul.view(view) + self.bias.view(view)


class ConvBNReLU3D(nn.Module):
    """Conv3d + BatchNorm + ReLU."""

    def __init__(self, c_in: int, features: int, kernel: int = 3,
                 stride: int = 1, pad: int = 0, fast_stem: bool = False):
        super().__init__()
        self.fast_stem = (fast_stem and kernel == 5 and stride == 2
                          and pad == 0 and c_in == 1)
        self.conv = Conv3d(c_in, features, kernel, stride, pad,
                           self.fast_stem)
        self.bn = BatchNorm3d(features)

    def forward(self, x, train: bool):
        return F.relu(self.bn(self.conv(x), train))


class AlexNet3D_Dropout(nn.Module):
    """5-conv 3D AlexNet with a dropout head."""

    def __init__(self, num_classes: int = 1, flat_features: int = 256,
                 fast_stem: bool = False):
        super().__init__()
        self.f0 = ConvBNReLU3D(1, 64, kernel=5, stride=2, pad=0,
                               fast_stem=fast_stem)
        self.f1 = ConvBNReLU3D(64, 128, kernel=3, stride=1, pad=0)
        self.f2 = ConvBNReLU3D(128, 192, kernel=3, pad=1)
        self.f3 = ConvBNReLU3D(192, 192, kernel=3, pad=1)
        self.f4 = ConvBNReLU3D(192, 128, kernel=3, pad=1)
        self.fc1 = Linear(flat_features, 64)
        self.fc2 = Linear(64, num_classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    @staticmethod
    def _dropout(x, i: int, dropout_masks, generator):
        keep = (dropout_masks[i] if dropout_masks is not None
                else torch.rand(x.shape, generator=generator,
                                device=x.device) < 0.5)
        return torch.where(keep, x / 0.5, torch.zeros_like(x))

    def forward(self, x, train: bool = False, dropout_masks=None,
                generator: torch.Generator | None = None):
        x = self.f0(x, train)
        x = F.max_pool3d(x, 3, 3)
        x = self.f1(x, train)
        x = F.max_pool3d(x, 3, 3)
        x = self.f2(x, train)
        x = self.f3(x, train)
        x = self.f4(x, train)
        x = F.max_pool3d(x, 3, 3)
        x = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)
        if train:
            x = self._dropout(x, 0, dropout_masks, generator)
        x = F.relu(self.fc1(x))
        if train:
            x = self._dropout(x, 1, dropout_masks, generator)
        return self.fc2(x)


def flat_features(shape: tuple[int, int, int]) -> int:
    """Input width of ``fc1`` for a [D, H, W] volume: 128 channels times
    the spatial size after the stem and the three pools."""
    def out(n):
        n = (n - 5) // 2 + 1   # stem, stride 2
        n = n // 3             # pool
        n = n - 2              # f1, kernel 3, no pad
        n = n // 3             # pool (f2-f4 keep the size)
        return n // 3          # pool
    return 128 * math.prod(out(n) for n in shape)
