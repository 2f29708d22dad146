"""The 3D CNNs of the ABCD work, layer for layer with the reference
package's flax definitions (its ``models/neuro3d.py``):
``AlexNet3D_Dropout`` (the flagship, ``--model 3DCNN``; with ``norm=
"group"`` the GroupNorm variant), ``AlexNet3D_Deeper_Dropout``,
``AlexNet3D_Dropout_Regression``, ``Tiny3DCNN`` and ``ResNet3D_l3`` (basic
or bottleneck blocks). Module attribute names are the flax module names
(``f0.bn``, ``f0.gn``, ``layer2_0.ds_conv``, ...), so ``weights.py``
carries a flax tree across leaf by leaf.

- Tensors are NCDHW inside (cuDNN's native layout). Before a flatten the
  features are permuted to channels-last, so a dense layer sees the
  reference's NDHWC feature order and a carried-across kernel needs no row
  permutation.
- ``dtype`` is the compute dtype, as flax's module ``dtype``: parameters
  stay float32 and are cast to it on every forward; the input, the
  convolutions, the dense layers and the activations run in it, and the
  logits are cast back to float32. Under ``torch.float32`` every cast is a
  no-op.
- Normalisation follows flax, not ``torch.nn``: statistics are taken in
  float32 (``E[x]`` and ``E[x^2] - E[x]^2`` clipped at 0), the input is
  normalised in float32 and the result cast to the layer's dtype. BatchNorm
  (epsilon 1e-5) moves its running stats by ``0.9 * old + 0.1 * new``
  with the biased variance, written in place into its buffers in training
  mode (the trainer hands in copies); ResNet3D's BatchNorms have dtype
  float32 whatever the model's. GroupNorm (``min(32, C)`` groups, epsilon
  1e-6) takes per-sample statistics over the spatial positions and each
  group's channels, and has no running stats.
- Dropout takes its keep-masks as an input (``dropout_masks``, one per
  dropout of the model, in order) or draws them from an explicit
  ``torch.Generator``; kept units are scaled by 2.
- Pooling has floor semantics (VALID windows; ResNet3D's padded max pool
  pads with -inf). Under ``NIDT_FAST_POOL=1`` a non-overlapping unpadded
  max pool runs ``ops.pooling.max_pool_3d_nonoverlap``, whose gradient is
  split equally across tied maxima, as in the reference.
- With ``fast_stem`` the 5^3 stride-2 single-channel stem runs through
  ``ops.stemconv.stem_conv3d`` (the hand-written weight gradient); the
  parameters are the same.
- ``remat`` (the AlexNet family): ``False``, ``"stem"`` (blocks f0 and
  f1) or ``True`` (every block) runs those ConvBNReLU3D blocks under
  ``torch.utils.checkpoint``: their activations are recomputed in the
  backward pass instead of kept. The checkpointed function is pure (the
  block's tensors come in as arguments and its batch statistics go out as
  results), so the recompute moves no running stat and the results equal
  the plain run's.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from neuroimagedisttraining_tpu_torch.ops.pooling import (
    max_pool_3d_nonoverlap,
)
from neuroimagedisttraining_tpu_torch.ops.stemconv import stem_conv3d

#: flax's lecun_normal: truncated normal on [-2, 2] std, rescaled so the
#: truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978
_VIEW = (1, -1, 1, 1, 1)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def _cast(t: torch.Tensor | None, dtype: torch.dtype):
    return t if t is None or t.dtype == dtype else t.to(dtype)


def max_pool(x: torch.Tensor, k: int, s: int, pad: int = 0) -> torch.Tensor:
    """Max pool (floor windows, -inf padding); ``NIDT_FAST_POOL=1`` takes
    non-overlapping unpadded windows through the tie-splitting op."""
    if s == k and pad == 0 and os.environ.get("NIDT_FAST_POOL") == "1":
        return max_pool_3d_nonoverlap(x, k)
    return F.max_pool3d(x, k, s, padding=pad)


# ---------------------------------------------------------------------------
# pure layer functions (the remat blocks take their tensors as arguments)
# ---------------------------------------------------------------------------

def conv3d(x, w, b, stride: int, pad: int, fast_stem: bool, dtype):
    """``conv3d`` in ``dtype`` (input, kernel and bias cast to it)."""
    x, w, b = _cast(x, dtype), _cast(w, dtype), _cast(b, dtype)
    if fast_stem:
        y = stem_conv3d(x, w)
        return y if b is None else y + b.view(_VIEW)
    return F.conv3d(x, w, b, stride=stride, padding=pad)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return _cast(x, torch.float32)


def _channel_view(x: torch.Tensor) -> tuple[int, ...]:
    """The view of a per-channel ``[C]`` vector against ``x`` (N, C, ...)."""
    return (1, -1) + (1,) * (x.dim() - 2)


def batch_stats(x: torch.Tensor):
    """``(x in float32, mean, biased variance)`` per channel of ``x``
    (NCDHW, or N, C and any spatial dims), flax's fast variance clipped at
    0."""
    xf = _f32(x)
    dims = (0, *range(2, xf.dim()))
    mean = xf.mean(dims)
    var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
    return xf, mean, var


def normalize(xf, mean, var, scale, bias, eps: float, dtype):
    """flax's ``_normalize`` in float32, then cast to ``dtype``; ``mean``
    and ``var`` are [C] or [B, C]; ``scale`` / ``bias`` None where the
    layer has none."""
    cview = _channel_view(xf)
    view = (*mean.shape, *cview[2:]) if mean.dim() == 2 else cview
    mul = torch.rsqrt(var + eps)
    if scale is not None:
        mul = mul * scale
    y = (xf - mean.view(view)) * mul.view(view)
    if bias is not None:
        y = y + bias.view(cview)
    return _cast(y, dtype)


def group_norm(x, scale, bias, groups: int, eps: float, dtype):
    """flax ``GroupNorm``: per-sample statistics over the spatial positions
    and each group's channels, in float32."""
    xf = _f32(x)
    b, c = xf.shape[:2]
    xg = xf.reshape(b, groups, c // groups, *xf.shape[2:])
    dims = tuple(range(2, xg.dim()))
    mean = xg.mean(dims)
    var = torch.clamp((xg * xg).mean(dims) - mean * mean, min=0.0)
    rep = c // groups
    return normalize(xf, mean.repeat_interleave(rep, dim=1),
                     var.repeat_interleave(rep, dim=1), scale, bias, eps,
                     dtype)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class Conv3d(nn.Module):
    """A 3D convolution: ``weight`` OIDHW and ``bias`` (none with
    ``bias=False``); ``fast_stem`` takes the stride-2 5^3 single-channel
    stem through ``ops.stemconv``."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 pad: int = 0, fast_stem: bool = False, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel, kernel,
                                               kernel))
        if bias:
            self.bias = nn.Parameter(torch.empty(c_out))
        else:
            self.register_parameter("bias", None)
        self.stride, self.pad = stride, pad
        self.fast_stem = fast_stem
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def run(self, x, w, b):
        return conv3d(x, w, b, self.stride, self.pad, self.fast_stem,
                      self.dtype)

    def forward(self, x):
        return self.run(x, self.weight, self.bias)


class Linear(nn.Module):
    """A dense layer in ``dtype``: ``weight`` [out, in], ``bias``."""

    def __init__(self, c_in: int, c_out: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in))
        self.bias = nn.Parameter(torch.empty(c_out))
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        d = self.dtype
        return F.linear(_cast(x, d), _cast(self.weight, d),
                        _cast(self.bias, d))


class BatchNorm3d(nn.Module):
    """BatchNorm with flax's statistics and momentum (see module doc) over
    N, C and any spatial dims; its output has ``dtype``. With ``affine``
    False it has no scale or bias (flax's ``use_scale=False,
    use_bias=False``)."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 affine: bool = True):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        if affine:
            self.weight = nn.Parameter(torch.empty(features))
            self.bias = nn.Parameter(torch.empty(features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.weight is not None:
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def train_run(self, x, scale, bias):
        """Training mode, pure: ``(y, mean, var)``."""
        xf, mean, var = batch_stats(x)
        return normalize(xf, mean, var, scale, bias, self.eps,
                         self.dtype), mean, var

    @torch.no_grad()
    def update(self, mean, var) -> None:
        """Move the running stats toward a batch's, in place."""
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def forward(self, x, train: bool):
        if train:
            y, mean, var = self.train_run(x, self.weight, self.bias)
            self.update(mean, var)
            return y
        return normalize(_f32(x), self.running_mean, self.running_var,
                         self.weight, self.bias, self.eps, self.dtype)


class GroupNorm3d(nn.Module):
    """flax ``GroupNorm(num_groups=min(32, C))`` over N, C and any spatial
    dims: epsilon 1e-6, no running stats; its output has ``dtype``."""

    def __init__(self, features: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.groups = min(32, features)
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def train_run(self, x, scale, bias):
        return (group_norm(x, scale, bias, self.groups, self.eps,
                           self.dtype),)

    def forward(self, x, train: bool):
        return self.train_run(x, self.weight, self.bias)[0]


class ConvBNReLU3D(nn.Module):
    """Conv3d + BatchNorm (``bn``) or GroupNorm (``gn``) + ReLU; with
    ``remat`` a training forward runs under ``torch.utils.checkpoint``."""

    def __init__(self, c_in: int, features: int, kernel: int = 3,
                 stride: int = 1, pad: int = 0, fast_stem: bool = False,
                 dtype: torch.dtype = torch.float32, norm: str = "batch",
                 remat: bool = False):
        super().__init__()
        self.fast_stem = (fast_stem and kernel == 5 and stride == 2
                          and pad == 0 and c_in == 1)
        self.conv = Conv3d(c_in, features, kernel, stride, pad,
                           self.fast_stem, dtype=dtype)
        if norm == "group":
            self.gn = GroupNorm3d(features, dtype=dtype)
        elif norm == "batch":
            self.bn = BatchNorm3d(features, dtype=dtype)
        else:
            raise ValueError(f"unknown norm {norm!r}")
        self.remat = remat

    @property
    def norm(self) -> nn.Module:
        return self.bn if hasattr(self, "bn") else self.gn

    def _train_block(self, x, cw, cb, nw, nb):
        """Training forward as a pure function of its tensors:
        ``(y, *batch stats)``."""
        y, *stats = self.norm.train_run(self.conv.run(x, cw, cb), nw, nb)
        return (F.relu(y), *stats)

    def forward(self, x, train: bool):
        if not train:
            return F.relu(self.norm(self.conv(x), False))
        args = (x, self.conv.weight, self.conv.bias, self.norm.weight,
                self.norm.bias)
        if self.remat:
            y, *stats = checkpoint(self._train_block, *args,
                                   use_reentrant=False)
        else:
            y, *stats = self._train_block(*args)
        if stats:
            self.norm.update(*stats)
        return y


def _dropout(x, i: int, dropout_masks, generator, rate: float = 0.5):
    """Dropout ``i`` of a model: keep-mask ``dropout_masks[i]`` where given,
    else drawn from ``generator``; kept units scaled by ``1 / (1 - rate)``."""
    keep = (dropout_masks[i] if dropout_masks is not None
            else torch.rand(x.shape, generator=generator,
                            device=x.device) < 1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _flatten_last(x: torch.Tensor) -> torch.Tensor:
    """NCDHW -> [B, D*H*W*C] in the reference's NDHWC order."""
    return x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)


class _Module3D(nn.Module):
    """What every model of the zoo shares: its init and compute dtype."""

    #: the rank of the input it takes (batch, channel, D, H, W)
    input_rank = 5

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)


# ---------------------------------------------------------------------------
# the AlexNet3D family
# ---------------------------------------------------------------------------

class _AlexNet3D(_Module3D):
    """The AlexNet3D trunk: the 5^3 stride-2 stem block f0, a pool, f1 (3^3,
    no padding), a pool, blocks f2... (3^3, padding 1), a pool; then the
    dropout head ``fc1`` (64) and ``fc2``."""

    def __init__(self, widths: Sequence[int], num_classes: int,
                 flat_features: int, fast_stem: bool, dtype: torch.dtype,
                 remat: bool | str, norm: str = "batch"):
        super().__init__()
        self.dtype = dtype
        self.depth = len(widths)
        c_in = 1
        for i, c in enumerate(widths):
            kw = (dict(kernel=5, stride=2, pad=0) if i == 0
                  else dict(kernel=3, stride=1, pad=0 if i == 1 else 1))
            setattr(self, f"f{i}", ConvBNReLU3D(
                c_in, c, fast_stem=fast_stem and i == 0, dtype=dtype,
                norm=norm, remat=remat is True or (remat == "stem"
                                                   and i <= 1), **kw))
            c_in = c
        self.fc1 = Linear(flat_features, 64, dtype)
        self.fc2 = Linear(64, num_classes, dtype)

    def features(self, x, train: bool):
        """The pooled NCDHW features of the trunk."""
        x = _cast(x, self.dtype)
        x = max_pool(self.f0(x, train), 3, 3)
        x = max_pool(self.f1(x, train), 3, 3)
        for i in range(2, self.depth):
            x = getattr(self, f"f{i}")(x, train)
        return max_pool(x, 3, 3)

    def head(self, xp, train: bool, dropout_masks, generator):
        """Float32 logits of the pooled features."""
        x = _flatten_last(xp)
        if train:
            x = _dropout(x, 0, dropout_masks, generator)
        x = F.relu(self.fc1(x))
        if train:
            x = _dropout(x, 1, dropout_masks, generator)
        return _f32(self.fc2(x))


class AlexNet3D_Dropout(_AlexNet3D):
    """5-conv 3D AlexNet with a dropout head, the ABCD flagship; with
    ``norm="group"`` its GroupNorm variant (``3dcnn_gn``)."""

    def __init__(self, num_classes: int = 1, flat_features: int = 256,
                 fast_stem: bool = False, dtype: torch.dtype = torch.float32,
                 remat: bool | str = False, norm: str = "batch"):
        super().__init__((64, 128, 192, 192, 128), num_classes,
                         flat_features, fast_stem, dtype, remat, norm)

    def forward(self, x, train: bool = False, dropout_masks=None,
                generator: torch.Generator | None = None):
        return self.head(self.features(x, train), train, dropout_masks,
                         generator)


class AlexNet3D_Deeper_Dropout(_AlexNet3D):
    """6-conv variant; returns ``(logits, logits)`` as the reference."""

    def __init__(self, num_classes: int = 1, flat_features: int = 512,
                 fast_stem: bool = False, dtype: torch.dtype = torch.float32,
                 remat: bool | str = False):
        super().__init__((64, 128, 192, 384, 256, 256), num_classes,
                         flat_features, fast_stem, dtype, remat)

    def forward(self, x, train: bool = False, dropout_masks=None,
                generator: torch.Generator | None = None):
        x = self.head(self.features(x, train), train, dropout_masks,
                      generator)
        return x, x


class AlexNet3D_Dropout_Regression(_AlexNet3D):
    """The flagship trunk with a regression head; returns
    ``(logits.squeeze(), pooled features)``, the features float32 in the
    reference's NDHWC layout (at batch 1 the squeeze leaves a scalar)."""

    def __init__(self, num_classes: int = 1, flat_features: int = 256,
                 fast_stem: bool = False, dtype: torch.dtype = torch.float32,
                 remat: bool | str = False):
        super().__init__((64, 128, 192, 192, 128), num_classes,
                         flat_features, fast_stem, dtype, remat)

    def forward(self, x, train: bool = False, dropout_masks=None,
                generator: torch.Generator | None = None):
        xp = self.features(x, train)
        logits = self.head(xp, train, dropout_masks, generator)
        return logits.squeeze(), _f32(xp.permute(0, 2, 3, 4, 1))


class Tiny3DCNN(_Module3D):
    """Two conv-BN-ReLU-pool stages (3^3 convs, 2^3 pools) and an MLP head
    with one dropout: the reference's structural miniature for small
    volumes."""

    def __init__(self, num_classes: int = 1, flat_features: int = 16,
                 width: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.f0 = ConvBNReLU3D(1, width, kernel=3, dtype=dtype)
        self.f1 = ConvBNReLU3D(width, 2 * width, kernel=3, dtype=dtype)
        self.fc1 = Linear(flat_features, 32, dtype)
        self.fc2 = Linear(32, num_classes, dtype)

    def forward(self, x, train: bool = False, dropout_masks=None,
                generator: torch.Generator | None = None):
        x = _cast(x, self.dtype)
        x = max_pool(self.f0(x, train), 2, 2)
        x = max_pool(self.f1(x, train), 2, 2)
        x = _flatten_last(x)
        if train:
            x = _dropout(x, 0, dropout_masks, generator)
        x = F.relu(self.fc1(x))
        return _f32(self.fc2(x))


# ---------------------------------------------------------------------------
# ResNet3D_l3
# ---------------------------------------------------------------------------

def _bn32(features: int) -> BatchNorm3d:
    """ResNet3D's BatchNorms: dtype float32 whatever the model's."""
    return BatchNorm3d(features, dtype=torch.float32)


class BasicBlock3D(nn.Module):
    """3D residual basic block: two 3^3 bias-free convs, BatchNorms in
    float32, a 1^3 strided projection ``ds_conv`` / ``ds_bn`` where
    ``downsample``."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv3d(inplanes, planes, 3, stride, 1, bias=False,
                            dtype=dtype)
        self.bn1 = _bn32(planes)
        self.conv2 = Conv3d(planes, planes, 3, 1, 1, bias=False, dtype=dtype)
        self.bn2 = _bn32(planes)
        if downsample:
            self.ds_conv = Conv3d(inplanes, planes, 1, stride, 0, bias=False,
                                  dtype=dtype)
            self.ds_bn = _bn32(planes)
        self.downsample = downsample

    def forward(self, x, train: bool):
        out = F.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        res = self.ds_bn(self.ds_conv(x), train) if self.downsample else x
        return F.relu(out + res)


class Bottleneck3D(nn.Module):
    """3D bottleneck block (1^3, 3^3 strided, 1^3 to 4x the planes)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv3d(inplanes, planes, 1, bias=False, dtype=dtype)
        self.bn1 = _bn32(planes)
        self.conv2 = Conv3d(planes, planes, 3, stride, 1, bias=False,
                            dtype=dtype)
        self.bn2 = _bn32(planes)
        self.conv3 = Conv3d(planes, 4 * planes, 1, bias=False, dtype=dtype)
        self.bn3 = _bn32(4 * planes)
        if downsample:
            self.ds_conv = Conv3d(inplanes, 4 * planes, 1, stride, 0,
                                  bias=False, dtype=dtype)
            self.ds_bn = _bn32(4 * planes)
        self.downsample = downsample

    def forward(self, x, train: bool):
        out = F.relu(self.bn1(self.conv1(x), train))
        out = F.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        res = self.ds_bn(self.ds_conv(x), train) if self.downsample else x
        return F.relu(out + res)


class ResNet3D_l3(_Module3D):
    """3-stage 3D ResNet: ``conv1`` (3^3, stride 2, padding 3, no bias),
    ``bn1``, a 3^3 stride-2 max pool padded by 1, stages ``layer{1,2,3}_i``
    of 64 / 128 / 256 planes (strides 1, 2, 2), a 3^3 average pool, ``fc``
    (512) and ``fc2``. Returns ``(logits, penultimate)``, both float32."""

    def __init__(self, num_classes: int = 1, flat_features: int = 256,
                 layers: Sequence[int] = (1, 1, 1), block: str = "basic",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        blk = BasicBlock3D if block == "basic" else Bottleneck3D
        self.conv1 = Conv3d(1, 64, 3, 2, 3, bias=False, dtype=dtype)
        self.bn1 = _bn32(64)
        self.blocks = []
        inplanes = 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256), layers)):
            for i in range(n):
                s = (1 if stage == 0 else 2) if i == 0 else 1
                ds = i == 0 and (s != 1 or inplanes != planes * blk.expansion)
                name = f"layer{stage + 1}_{i}"
                setattr(self, name, blk(inplanes, planes, s, ds, dtype))
                self.blocks.append(name)
                inplanes = planes * blk.expansion
        self.fc = Linear(flat_features * blk.expansion, 512, dtype)
        self.fc2 = Linear(512, num_classes, dtype)

    def forward(self, x, train: bool = False, dropout_masks=None,
                generator: torch.Generator | None = None):
        x = _cast(x, self.dtype)
        x = F.relu(self.bn1(self.conv1(x), train))
        x = max_pool(x, 3, 2, pad=1)
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        x = _flatten_last(F.avg_pool3d(x, 3, 3))
        x1 = self.fc(x)
        return _f32(self.fc2(x1)), _f32(x1)


# ---------------------------------------------------------------------------
# dense input widths
# ---------------------------------------------------------------------------

def _alexnet_out(n: int) -> int:
    n = (n - 5) // 2 + 1   # stem, stride 2
    n = n // 3             # pool
    n = n - 2              # f1, kernel 3, no pad
    n = n // 3             # pool (the padded blocks keep the size)
    return n // 3          # pool


def flat_features(shape: tuple[int, int, int], channels: int = 128) -> int:
    """Input width of the AlexNet family's ``fc1`` for a [D, H, W] volume:
    the last block's channels (128; the deeper variant's 256) times the
    spatial size after the stem and the three pools."""
    return channels * math.prod(_alexnet_out(n) for n in shape)


def tiny_flat_features(shape: tuple[int, int, int], width: int = 8) -> int:
    """``Tiny3DCNN``'s ``fc1`` input width: two (3^3 conv, 2^3 pool)."""
    return 2 * width * math.prod(((n - 2) // 2 - 2) // 2 for n in shape)


def resnet_flat_features(shape: tuple[int, int, int]) -> int:
    """``ResNet3D_l3``'s ``fc`` input width over the expansion: 256 planes
    times the positions after the stem, the pool, two stride-2 stages and
    the 3^3 average pool."""
    def out(n):
        n = (n + 6 - 3) // 2 + 1      # conv1, stride 2, pad 3
        n = (n + 2 - 3) // 2 + 1      # max pool 3, stride 2, pad 1
        n = (n + 2 - 3) // 2 + 1      # layer2, stride 2
        n = (n + 2 - 3) // 2 + 1      # layer3, stride 2
        return (n - 3) // 3 + 1       # average pool 3
    return 256 * math.prod(out(n) for n in shape)
