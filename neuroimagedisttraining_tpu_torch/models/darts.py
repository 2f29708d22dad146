"""The DARTS family, layer for layer with the reference package's flax
definitions (its ``models/darts.py``): the candidate operations, the
search supernet (softmax mixture or GDAS), genotype derivation, the
fixed-genotype network with drop-path and the auxiliary head, the exact
unrolled architect and the two drivers, ``DartsSearch`` and
``DartsTrainer``.

The 2D zoo's conventions hold (``layers2d.py``): tensors NCHW inside,
parameters float32 and cast to the compute ``dtype`` on every forward,
float32 logits. Module attribute names are flax's auto-names
(``FixedCell_12._Op_3.SepConv_0.Conv_1``, ``SearchCell_0.MixedOp_4._Op_7``,
``AuxiliaryHead_0``), so ``weights.py`` carries a tree across leaf by
leaf; the search net's ``alphas_normal`` / ``alphas_reduce`` are
top-level parameters beside the weights (not maskable: no ``weight``).

- Normalisation has two modes (``_BN``). Search mode (``track=False``):
  the batch's own statistics in training and evaluation, the two-pass
  biased variance, no running stats, an optional scale and bias. Fixed
  mode: ``neuro3d.BatchNorm3d`` (momentum 0.9, epsilon 1e-5, the
  ``E[x^2] - E[x]^2`` statistics), nested as flax nests it
  (``_BN_0.BatchNorm_0``).
- Pools: 3x3 average with torch's ``count_include_pad=False`` (the
  reference divides by a pooled ones-map: the same at strides 1 and 2),
  3x3 max with -inf padding. Dilated convs pad ``dilation * (k - 1) // 2``
  on each side (not XLA's "SAME").
- Randomness comes in as inputs or from an explicit ``torch.Generator``:
  drop-path keep-masks (``drop_path_masks``, one ``[B, 1, 1, 1]`` mask
  per non-identity edge in the order the cells apply them) and GDAS's
  Gumbel draws (``gumbel_draws``: the normal and reduce cells' ``[k,
  8]``).
- The architect differentiates the inner SGD step exactly
  (``torch.autograd.grad`` with ``create_graph=True`` through ``w' = w -
  eta * (mu * buf + dL_train/dw + wd * w)``), as the reference does with
  ``jax.grad``; the reference's torch code takes a finite difference.
- The drivers' weight step is the port's SGD chain (global-norm clip,
  ``+ wd * w``, momentum, ``-lr``), the fused CUDA step on CUDA tensors
  (``ops/fused_update.py``), at the reference's cosine-annealed lr.
"""

from __future__ import annotations

import functools
import math
from collections import namedtuple
from typing import Iterator

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from neuroimagedisttraining_tpu_torch.core.losses import softmax_ce
from neuroimagedisttraining_tpu_torch.core.optim import _bias_correction
from neuroimagedisttraining_tpu_torch.models.layers2d import Conv2d, Module2D
from neuroimagedisttraining_tpu_torch.models.neuro3d import (
    BatchNorm3d, Linear, _cast, _f32,
)
from neuroimagedisttraining_tpu_torch.ops.fused_update import fused_sgd_step

Genotype = namedtuple("Genotype", "normal normal_concat reduce reduce_concat")

PRIMITIVES = (
    "none",
    "max_pool_3x3",
    "avg_pool_3x3",
    "skip_connect",
    "sep_conv_3x3",
    "sep_conv_5x5",
    "dil_conv_3x3",
    "dil_conv_5x5",
)

# the published architectures (the reference's genotypes.py)
DARTS_V1 = Genotype(
    normal=[("sep_conv_3x3", 1), ("sep_conv_3x3", 0), ("skip_connect", 0),
            ("sep_conv_3x3", 1), ("skip_connect", 0), ("sep_conv_3x3", 1),
            ("sep_conv_3x3", 0), ("skip_connect", 2)],
    normal_concat=[2, 3, 4, 5],
    reduce=[("max_pool_3x3", 0), ("max_pool_3x3", 1), ("skip_connect", 2),
            ("max_pool_3x3", 0), ("max_pool_3x3", 0), ("skip_connect", 2),
            ("skip_connect", 2), ("avg_pool_3x3", 0)],
    reduce_concat=[2, 3, 4, 5])
DARTS_V2 = Genotype(
    normal=[("sep_conv_3x3", 0), ("sep_conv_3x3", 1), ("sep_conv_3x3", 0),
            ("sep_conv_3x3", 1), ("sep_conv_3x3", 1), ("skip_connect", 0),
            ("skip_connect", 0), ("dil_conv_3x3", 2)],
    normal_concat=[2, 3, 4, 5],
    reduce=[("max_pool_3x3", 0), ("max_pool_3x3", 1), ("skip_connect", 2),
            ("max_pool_3x3", 1), ("max_pool_3x3", 0), ("skip_connect", 2),
            ("skip_connect", 2), ("max_pool_3x3", 1)],
    reduce_concat=[2, 3, 4, 5])
FedNAS_V1 = Genotype(
    normal=[("sep_conv_3x3", 1), ("sep_conv_3x3", 0), ("sep_conv_3x3", 2),
            ("sep_conv_5x5", 0), ("sep_conv_3x3", 1), ("sep_conv_5x5", 3),
            ("dil_conv_5x5", 3), ("sep_conv_3x3", 4)],
    normal_concat=list(range(2, 6)),
    reduce=[("max_pool_3x3", 0), ("skip_connect", 1), ("max_pool_3x3", 0),
            ("max_pool_3x3", 2), ("max_pool_3x3", 0), ("dil_conv_5x5", 1),
            ("max_pool_3x3", 0), ("dil_conv_5x5", 2)],
    reduce_concat=list(range(2, 6)))
DARTS = DARTS_V2


def num_edges(steps: int) -> int:
    """Edges of a search cell of ``steps`` nodes: node i has i + 2
    inputs."""
    return sum(2 + i for i in range(steps))


# ---------------------------------------------------------------------------
# candidate operations
# ---------------------------------------------------------------------------

#: flax's bias-free ``nn.Conv``
Conv = functools.partial(Conv2d, bias=False)


def avg_pool_3x3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """3x3 average pool, padding 1, each window's sum over its real
    (unpadded) elements."""
    return F.avg_pool2d(x, 3, stride, 1, count_include_pad=False)


def max_pool_3x3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """3x3 max pool, padding 1 with -inf."""
    return F.max_pool2d(x, 3, stride, 1)


def search_batch_norm(x, scale, bias, dtype, eps: float = 1e-5):
    """Search-mode normalisation: the batch's mean and two-pass biased
    variance per channel, taken in float32 and rounded to ``x``'s dtype
    (``jnp.mean`` / ``jnp.var``), ``(x - mean) * rsqrt(var + eps)`` in
    ``x``'s dtype, then the float32 scale and bias where given; the result
    in ``dtype``."""
    xf = _f32(x)
    mean = xf.mean((0, 2, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean((0, 2, 3), keepdim=True)
    y = (x - mean.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + eps)
    if scale is not None:
        y = y * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    return _cast(y, dtype)


class _BN(nn.Module):
    """Normalisation in the reference's two modes (see the module doc):
    search mode holds ``weight`` / ``bias`` itself (``affine``) or
    nothing; fixed mode (``track``) a flax-style ``BatchNorm_0``."""

    def __init__(self, features: int, affine: bool = True,
                 track: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.track, self.dtype = track, dtype
        if track:
            self.BatchNorm_0 = BatchNorm3d(features, momentum=0.9, eps=1e-5,
                                           dtype=dtype, affine=affine)
        elif affine:
            self.weight = nn.Parameter(torch.empty(features))
            self.bias = nn.Parameter(torch.empty(features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if not self.track and self.weight is not None:
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)

    def forward(self, x, train: bool):
        if self.track:
            return self.BatchNorm_0(x, train)
        return search_batch_norm(x, self.weight, self.bias, self.dtype)


class ReLUConvBN(nn.Module):
    """ReLU, a k x k conv (padding (k - 1) // 2), the norm."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 affine: bool = True, track: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(c_in, c_out, kernel, stride, (kernel - 1) // 2,
                           dtype=dtype)
        self._BN_0 = _BN(c_out, affine, track, dtype)

    def forward(self, x, train: bool):
        return self._BN_0(self.Conv_0(F.relu(x)), train)


class SepConv(nn.Module):
    """Two stacked depthwise-separable convs, each ReLU, depthwise k x k,
    pointwise 1x1, norm; the first carries the stride."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 affine: bool = True, track: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        p = (kernel - 1) // 2
        self.Conv_0 = Conv(c_in, c_in, kernel, stride, p, groups=c_in,
                           dtype=dtype)
        self.Conv_1 = Conv(c_in, c_in, 1, dtype=dtype)
        self._BN_0 = _BN(c_in, affine, track, dtype)
        self.Conv_2 = Conv(c_in, c_in, kernel, 1, p, groups=c_in,
                           dtype=dtype)
        self.Conv_3 = Conv(c_in, c_out, 1, dtype=dtype)
        self._BN_1 = _BN(c_out, affine, track, dtype)

    def forward(self, x, train: bool):
        x = self._BN_0(self.Conv_1(self.Conv_0(F.relu(x))), train)
        return self._BN_1(self.Conv_3(self.Conv_2(F.relu(x))), train)


class DilConv(nn.Module):
    """ReLU, a dilated depthwise k x k conv (padding ``dilation * (k - 1)
    // 2``), a pointwise 1x1 conv, the norm."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 dilation: int = 2, affine: bool = True, track: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(c_in, c_in, kernel, stride,
                           dilation * (kernel - 1) // 2, dtype=dtype,
                           dilation=dilation, groups=c_in)
        self.Conv_1 = Conv(c_in, c_out, 1, dtype=dtype)
        self._BN_0 = _BN(c_out, affine, track, dtype)

    def forward(self, x, train: bool):
        return self._BN_0(self.Conv_1(self.Conv_0(F.relu(x))), train)


class FactorizedReduce(nn.Module):
    """The stride-2 reduce: ReLU, two 1x1 stride-2 unpadded convs of
    ``c_out // 2`` channels, the second on ``x[:, :, 1:, 1:]``,
    concatenated on channels, the norm."""

    def __init__(self, c_in: int, c_out: int, affine: bool = True,
                 track: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(c_in, c_out // 2, 1, 2, dtype=dtype)
        self.Conv_1 = Conv(c_in, c_out // 2, 1, 2, dtype=dtype)
        self._BN_0 = _BN(c_out, affine, track, dtype)

    def forward(self, x, train: bool):
        x = F.relu(x)
        out = torch.cat([self.Conv_0(x), self.Conv_1(x[:, :, 1:, 1:])], 1)
        return self._BN_0(out, train)


class Conv7x1_1x7(nn.Module):
    """The factorized 7x7 (the NASNet genotype's; no genotype here uses
    it): ReLU, a 1x7 conv (stride along W), a 7x1 conv (stride along H),
    the norm."""

    def __init__(self, c_in: int, c_out: int, stride: int,
                 affine: bool = True, track: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(c_in, c_out, (1, 7), (1, stride), (0, 3),
                           dtype=dtype)
        self.Conv_1 = Conv(c_out, c_out, (7, 1), (stride, 1), (3, 0),
                           dtype=dtype)
        self._BN_0 = _BN(c_out, affine, track, dtype)

    def forward(self, x, train: bool):
        return self._BN_0(self.Conv_1(self.Conv_0(F.relu(x))), train)


def _zero(x: torch.Tensor, stride: int) -> torch.Tensor:
    """The ``none`` op: zeros of the output's shape."""
    if stride == 1:
        return torch.zeros_like(x)
    return torch.zeros_like(x[:, :, ::stride, ::stride])


class _Op(nn.Module):
    """One primitive by name on ``c`` channels. In search mode
    (``bn_after_pool``) a pool is followed by an affine-less norm
    (``_BN_0``)."""

    def __init__(self, prim: str, c: int, stride: int, affine: bool = True,
                 track: bool = False, bn_after_pool: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.prim, self.stride = prim, stride
        self.bn_after_pool = bn_after_pool
        kw = dict(affine=affine, track=track, dtype=dtype)
        if prim == "skip_connect" and stride != 1:
            self.FactorizedReduce_0 = FactorizedReduce(c, c, **kw)
        elif prim in ("max_pool_3x3", "avg_pool_3x3"):
            if bn_after_pool:
                self._BN_0 = _BN(c, False, track, dtype)
        elif prim.startswith("sep_conv"):
            self.SepConv_0 = SepConv(c, c, int(prim[-1]), stride, **kw)
        elif prim.startswith("dil_conv"):
            self.DilConv_0 = DilConv(c, c, int(prim[-1]), stride, 2, **kw)
        elif prim == "conv_7x1_1x7":
            self.Conv7x1_1x7_0 = Conv7x1_1x7(c, c, stride, **kw)
        elif prim not in ("none", "skip_connect"):
            raise ValueError(f"unknown primitive {prim!r}")

    @property
    def is_identity(self) -> bool:
        return self.prim == "skip_connect" and self.stride == 1

    def forward(self, x, train: bool):
        n, s = self.prim, self.stride
        if n == "none":
            return _zero(x, s)
        if n == "skip_connect":
            return x if s == 1 else self.FactorizedReduce_0(x, train)
        if n in ("max_pool_3x3", "avg_pool_3x3"):
            y = max_pool_3x3(x, s) if n == "max_pool_3x3" else avg_pool_3x3(
                x, s)
            return self._BN_0(y, train) if self.bn_after_pool else y
        if n.startswith("sep_conv"):
            return self.SepConv_0(x, train)
        if n.startswith("dil_conv"):
            return self.DilConv_0(x, train)
        return self.Conv7x1_1x7_0(x, train)


# ---------------------------------------------------------------------------
# the search network
# ---------------------------------------------------------------------------

class MixedOp(nn.Module):
    """The weighted sum over every primitive (``_Op_0`` ... ``_Op_7``), in
    ``PRIMITIVES`` order from 0, each output in float32 as the reference's
    float32 weight promotes it."""

    def __init__(self, c: int, stride: int, dtype: torch.dtype):
        super().__init__()
        for i, p in enumerate(PRIMITIVES):
            setattr(self, f"_Op_{i}", _Op(p, c, stride, affine=False,
                                          bn_after_pool=True, dtype=dtype))

    def forward(self, x, weights, train: bool):
        outs = [getattr(self, f"_Op_{i}")(x, train)
                for i in range(len(PRIMITIVES))]
        return sum(w * _f32(o) for w, o in zip(weights, outs))


def _preprocess(c_prev_prev: int, c_prev: int, c: int, reduction_prev: bool,
                kw: dict) -> list[tuple[str, nn.Module]]:
    """A cell's two input projections by flax name: ``s0`` through a
    ``FactorizedReduce`` after a reduction cell, else a 1x1
    ``ReLUConvBN``; ``s1`` through a 1x1 ``ReLUConvBN``."""
    if reduction_prev:
        return [("FactorizedReduce_0", FactorizedReduce(c_prev_prev, c, **kw)),
                ("ReLUConvBN_0", ReLUConvBN(c_prev, c, 1, 1, **kw))]
    return [("ReLUConvBN_0", ReLUConvBN(c_prev_prev, c, 1, 1, **kw)),
            ("ReLUConvBN_1", ReLUConvBN(c_prev, c, 1, 1, **kw))]


class _Cell(nn.Module):
    """What both cells share: the input projections."""

    def _build_preprocess(self, c_prev_prev, c_prev, c, reduction_prev, kw):
        names = []
        for name, mod in _preprocess(c_prev_prev, c_prev, c, reduction_prev,
                                     kw):
            setattr(self, name, mod)
            names.append(name)
        self._pre = names

    def preprocess(self, s0, s1, train: bool):
        return (getattr(self, self._pre[0])(s0, train),
                getattr(self, self._pre[1])(s1, train))


class SearchCell(_Cell):
    """The DAG cell: two projected inputs and ``steps`` nodes, each the sum
    of mixed ops (``MixedOp_0`` ...) over every earlier state; the last
    ``multiplier`` states concatenated."""

    def __init__(self, c_prev_prev: int, c_prev: int, c: int, steps: int,
                 multiplier: int, reduction: bool, reduction_prev: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.steps, self.multiplier = steps, multiplier
        self._build_preprocess(c_prev_prev, c_prev, c, reduction_prev,
                               dict(affine=False, track=False, dtype=dtype))
        k = 0
        for i in range(steps):
            for j in range(2 + i):
                stride = 2 if reduction and j < 2 else 1
                setattr(self, f"MixedOp_{k}", MixedOp(c, stride, dtype))
                k += 1

    def forward(self, s0, s1, weights, train: bool):
        states = list(self.preprocess(s0, s1, train))
        offset = 0
        for _ in range(self.steps):
            s = sum(getattr(self, f"MixedOp_{offset + j}")(
                h, weights[offset + j], train) for j, h in enumerate(states))
            offset += len(states)
            states.append(s)
        return torch.cat(states[-self.multiplier:], 1)


def gumbel_draws(shape, generator: torch.Generator,
                 device=None) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, ``u`` uniform on [tiny,
    1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _gumbel_hard(logits: torch.Tensor, g: torch.Tensor,
                 tau: float) -> torch.Tensor:
    """Straight-through Gumbel-softmax rows (GDAS): the hard one-hot
    forward, the soft gradient."""
    soft = torch.softmax((logits + g) / tau, dim=-1)
    hard = F.one_hot(torch.argmax(soft, -1), logits.shape[-1]).to(soft.dtype)
    return hard + soft - soft.detach()


class DartsSearchNet(Module2D):
    """The over-parameterised search supernet: ``alphas_normal`` /
    ``alphas_reduce`` ``[num_edges(steps), 8]`` (N(0, 1e-3)), a 3x3 stem
    ``Conv_0`` of ``stem_multiplier * c`` channels with the affine
    search-mode ``_BN_0``, ``layers`` search cells (``SearchCell_i``; the
    reductions at ``layers // 3`` and ``2 * layers // 3`` double the
    width), the global mean pool and ``Dense_0``. The edge weights are the
    softmax of the alphas, or under ``gumbel`` the straight-through
    Gumbel-softmax in training (``gumbel_draws`` ``(normal, reduce)``, or
    drawn from ``generator``) and the noise-free argmax one-hot in
    evaluation. Its norms take the batch's statistics in evaluation too
    (``eval_batch_stats``)."""

    eval_batch_stats = True

    def __init__(self, c: int = 16, num_classes: int = 10, layers: int = 8,
                 steps: int = 4, multiplier: int = 4,
                 stem_multiplier: int = 3, gumbel: bool = False,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.c, self.layers, self.steps = c, layers, steps
        self.multiplier, self.gumbel, self.dtype = multiplier, gumbel, dtype
        k = num_edges(steps)
        self.alphas_normal = nn.Parameter(torch.empty(k, len(PRIMITIVES)))
        self.alphas_reduce = nn.Parameter(torch.empty(k, len(PRIMITIVES)))
        c_curr = stem_multiplier * c
        self.Conv_0 = Conv(in_channels, c_curr, 3, 1, 1, dtype=dtype)
        self._BN_0 = _BN(c_curr, True, False, dtype)
        c_pp, c_p, c_curr = c_curr, c_curr, c
        reduction_prev = False
        self.reductions = []
        for i in range(layers):
            reduction = i in (layers // 3, 2 * layers // 3)
            if reduction:
                c_curr *= 2
            setattr(self, f"SearchCell_{i}", SearchCell(
                c_pp, c_p, c_curr, steps, multiplier, reduction,
                reduction_prev, dtype))
            self.reductions.append(reduction)
            reduction_prev = reduction
            c_pp, c_p = c_p, multiplier * c_curr
        self.Dense_0 = Linear(c_p, num_classes, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        with torch.no_grad():
            for a in (self.alphas_normal, self.alphas_reduce):
                a.normal_(0.0, 1e-3, generator=generator)

    def edge_weights(self, train: bool, tau: float, gumbel_draws_=None,
                     generator: torch.Generator | None = None):
        """The normal and reduce cells' edge weights ``[k, 8]``."""
        an, ar = self.alphas_normal, self.alphas_reduce
        n = len(PRIMITIVES)
        if self.gumbel and not train:
            return (F.one_hot(torch.argmax(an, -1), n).to(torch.float32),
                    F.one_hot(torch.argmax(ar, -1), n).to(torch.float32))
        if self.gumbel:
            if gumbel_draws_ is None:
                gumbel_draws_ = tuple(gumbel_draws(a.shape, generator,
                                                   a.device) for a in (an, ar))
            gn, gr = gumbel_draws_
            return _gumbel_hard(an, gn, tau), _gumbel_hard(ar, gr, tau)
        return torch.softmax(an, -1), torch.softmax(ar, -1)

    def forward(self, x, train: bool = False, tau: float = 1.0,
                gumbel_draws=None, generator: torch.Generator | None = None,
                dropout_masks=None):
        """Float32 logits of NCHW ``x`` (``dropout_masks``: the trainer's
        argument; the net has no dropout)."""
        w_normal, w_reduce = self.edge_weights(train, tau, gumbel_draws,
                                               generator)
        s = self._BN_0(self.Conv_0(_cast(x, self.dtype)), train)
        s0 = s1 = s
        for i, reduction in enumerate(self.reductions):
            cell = getattr(self, f"SearchCell_{i}")
            s0, s1 = s1, cell(s0, s1, w_reduce if reduction else w_normal,
                              train)
        return _f32(self.Dense_0(s1.mean((2, 3))))


def derive_genotype(alphas_normal, alphas_reduce, steps: int = 4,
                    multiplier: int = 4) -> Genotype:
    """The discrete architecture of arch logits: per node the 2 incoming
    edges of the highest best-non-``none`` weight (a stable sort on
    ``-best``), per kept edge its best non-``none`` op (the first
    maximum)."""

    def _parse(alphas):
        w = torch.softmax(torch.as_tensor(alphas).detach().to(
            torch.float32).cpu(), -1).numpy()
        none_idx = PRIMITIVES.index("none")
        ks = [k for k in range(len(PRIMITIVES)) if k != none_idx]
        gene, start = [], 0
        for i in range(steps):
            n = i + 2
            rows = w[start:start + n]
            best = [max(rows[j][k] for k in ks) for j in range(n)]
            edges = sorted(range(n), key=lambda j: -best[j])[:2]
            for j in sorted(edges):
                k_best = max(ks, key=lambda k: rows[j][k])
                gene.append((PRIMITIVES[k_best], j))
            start += n
        return gene

    concat = list(range(2 + steps - multiplier, steps + 2))
    return Genotype(normal=_parse(alphas_normal), normal_concat=concat,
                    reduce=_parse(alphas_reduce), reduce_concat=concat)


# ---------------------------------------------------------------------------
# the fixed-genotype network
# ---------------------------------------------------------------------------

def _keep(prob: float) -> float:
    """``1 - prob`` in float32."""
    return float(np.float32(1.0) - np.float32(prob))


def keep_masks(n: int, batch: int, prob: float,
               generator: torch.Generator | None, device) -> list:
    """``n`` drop-path keep-masks ``[batch, 1, 1, 1]``, Bernoulli(1 -
    ``prob``) draws from ``generator``."""
    return [torch.rand((batch, 1, 1, 1), generator=generator, device=device)
            < _keep(prob) for _ in range(n)]


def _drop_path(x: torch.Tensor, keep_mask: torch.Tensor,
               prob: float) -> torch.Tensor:
    """``x * mask / (1 - prob)``."""
    return x * keep_mask.to(x.dtype) / _keep(prob)


class FixedCell(_Cell):
    """A cell compiled from a genotype: per node two incoming edges of
    fixed ops (``_Op_0`` ...), summed; the genotype's concat states joined
    on channels. Drop-path runs on every edge but a true identity (a
    stride-1 ``skip_connect``; a stride-2 one is a ``FactorizedReduce``
    and is dropped)."""

    def __init__(self, genotype: Genotype, c_prev_prev: int, c_prev: int,
                 c: int, reduction: bool, reduction_prev: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(affine=True, track=True, dtype=dtype)
        self._build_preprocess(c_prev_prev, c_prev, c, reduction_prev, kw)
        gene = genotype.reduce if reduction else genotype.normal
        self.concat = list(genotype.reduce_concat if reduction
                           else genotype.normal_concat)
        self.indices = [idx for _, idx in gene]
        for slot, (name, idx) in enumerate(gene):
            stride = 2 if reduction and idx < 2 else 1
            setattr(self, f"_Op_{slot}", _Op(name, c, stride, **kw))

    def drop_path_edges(self) -> int:
        return sum(not getattr(self, f"_Op_{s}").is_identity
                   for s in range(len(self.indices)))

    def forward(self, s0, s1, train: bool, drop_prob: float,
                masks: Iterator[torch.Tensor] | None):
        """``masks`` yields the keep-mask of each dropped edge in order;
        None applies no drop-path."""
        states = list(self.preprocess(s0, s1, train))
        for i in range(len(self.indices) // 2):
            hs = []
            for slot in (2 * i, 2 * i + 1):
                op = getattr(self, f"_Op_{slot}")
                h = op(states[self.indices[slot]], train)
                if train and masks is not None and not op.is_identity:
                    h = _drop_path(h, next(masks), drop_prob)
                hs.append(h)
            states.append(hs[0] + hs[1])
        return torch.cat([states[i] for i in self.concat], 1)


class AuxiliaryHead(nn.Module):
    """The CIFAR auxiliary classifier on an 8x8 input: ReLU, a 5x5 stride-3
    unpadded average (sum / 25), ``Conv_0`` 1x1 to 128, norm, ReLU,
    ``Conv_1`` 2x2 unpadded to 768, norm, ReLU, ``Dense_0``."""

    def __init__(self, c_in: int, num_classes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(c_in, 128, 1, dtype=dtype)
        self._BN_0 = _BN(128, True, True, dtype)
        self.Conv_1 = Conv(128, 768, 2, dtype=dtype)
        self._BN_1 = _BN(768, True, True, dtype)
        self.Dense_0 = Linear(768, num_classes, dtype)

    def forward(self, x, train: bool):
        x = F.avg_pool2d(F.relu(x), 5, 3)
        x = F.relu(self._BN_0(self.Conv_0(x), train))
        x = F.relu(self._BN_1(self.Conv_1(x), train))
        return self.Dense_0(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


class DartsNetwork(Module2D):
    """The evaluation network of a genotype (NetworkCIFAR): a 3x3 stem
    ``Conv_0`` of ``stem_multiplier * c`` channels and its tracked
    ``_BN_0``, ``layers`` fixed cells (reductions at ``layers // 3`` and
    ``2 * layers // 3``), ``AuxiliaryHead_0`` after cell ``2 * layers //
    3`` where ``auxiliary`` (its parameters exist in both modes), the
    global mean pool and ``Dense_0``. Returns ``(logits, logits_aux)``,
    float32; ``logits_aux`` is None unless training with ``auxiliary``.

    Drop-path (training): ``drop_path_masks``, the keep-masks of every
    dropped edge in order (``drop_path_edges()`` of them), or, where
    ``drop_path_prob`` is not 0, masks drawn from ``generator``; at a
    ``drop_path_prob`` of 0 without masks no draw is made."""

    def __init__(self, genotype: Genotype = DARTS_V2, c: int = 36,
                 num_classes: int = 10, layers: int = 20,
                 auxiliary: bool = False, stem_multiplier: int = 3,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.genotype, self.c, self.layers = genotype, c, layers
        self.auxiliary, self.dtype = auxiliary, dtype
        c_curr = stem_multiplier * c
        self.Conv_0 = Conv(in_channels, c_curr, 3, 1, 1, dtype=dtype)
        self._BN_0 = _BN(c_curr, True, True, dtype)
        c_pp, c_p, c_curr = c_curr, c_curr, c
        reduction_prev = False
        self.aux_layer = 2 * layers // 3
        for i in range(layers):
            reduction = i in (layers // 3, 2 * layers // 3)
            if reduction:
                c_curr *= 2
            setattr(self, f"FixedCell_{i}", FixedCell(
                genotype, c_pp, c_p, c_curr, reduction, reduction_prev,
                dtype))
            reduction_prev = reduction
            c_pp, c_p = c_p, len(genotype.normal_concat) * c_curr
            if i == self.aux_layer and auxiliary:
                self.AuxiliaryHead_0 = AuxiliaryHead(c_p, num_classes, dtype)
        self.Dense_0 = Linear(c_p, num_classes, dtype)

    def drop_path_edges(self) -> int:
        """Edges a training forward drop-paths (one keep-mask each)."""
        return sum(getattr(self, f"FixedCell_{i}").drop_path_edges()
                   for i in range(self.layers))

    def forward(self, x, train: bool = False, drop_path_prob: float = 0.0,
                drop_path_masks=None, generator: torch.Generator | None = None,
                dropout_masks=None):
        """``(logits, logits_aux)`` of NCHW ``x`` (``dropout_masks``: the
        trainer's argument; the net has no dropout)."""
        masks = None
        if train and drop_path_masks is None and drop_path_prob != 0:
            drop_path_masks = keep_masks(self.drop_path_edges(), x.shape[0],
                                         drop_path_prob, generator, x.device)
        if train and drop_path_masks is not None:
            masks = iter(drop_path_masks)
        s = self._BN_0(self.Conv_0(_cast(x, self.dtype)), train)
        s0 = s1 = s
        logits_aux = None
        for i in range(self.layers):
            s0, s1 = s1, getattr(self, f"FixedCell_{i}")(
                s0, s1, train, drop_path_prob, masks)
            if i == self.aux_layer and self.auxiliary and train:
                logits_aux = _f32(self.AuxiliaryHead_0(s1, train))
        return _f32(self.Dense_0(s1.mean((2, 3)))), logits_aux


# ---------------------------------------------------------------------------
# the architect: the exact gradient of the unrolled objective
# ---------------------------------------------------------------------------

ARCH_KEYS = ("alphas_normal", "alphas_reduce")


def split_arch(params: dict) -> tuple[dict, dict]:
    """``(arch, weights)``: a search net's parameters by name."""
    arch = {k: params[k] for k in ARCH_KEYS}
    weights = {k: v for k, v in params.items() if k not in ARCH_KEYS}
    return arch, weights


def merge_arch(arch: dict, weights: dict) -> dict:
    return {**weights, **arch}


def _leaves(tree: dict) -> dict:
    return {k: v.detach().requires_grad_(True) for k, v in tree.items()}


def arch_grad_unrolled(loss_fn, params: dict, train_batch, val_batch,
                       eta: float, momentum: float = 0.9,
                       weight_decay: float = 3e-4,
                       momentum_buf: dict | None = None) -> dict:
    """The exact gradient with respect to the alphas of
    ``L_val(w - eta * (mu * buf + dL_train/dw + wd * w), alpha)``
    (``loss_fn(params, batch) -> scalar``): the inner gradient is taken
    with ``create_graph=True`` and differentiated through."""
    arch, weights = split_arch(params)
    a, w = _leaves(arch), _leaves(weights)
    if momentum_buf is None:
        momentum_buf = {k: torch.zeros_like(v) for k, v in weights.items()}
    g_w = torch.autograd.grad(loss_fn(merge_arch(a, w), train_batch),
                              list(w.values()), create_graph=True)
    w2 = {k: w[k] - eta * (momentum * momentum_buf[k] + g
                           + weight_decay * w[k])
          for k, g in zip(w, g_w)}
    g_a = torch.autograd.grad(loss_fn(merge_arch(a, w2), val_batch),
                              list(a.values()))
    return dict(zip(a, g_a))


def arch_grad_regularized(loss_fn, params: dict, train_batch, val_batch,
                          lambda_train: float = 1.0,
                          lambda_valid: float = 1.0) -> dict:
    """FedNAS's first-order arch gradient, ``lambda_valid * dL_val/da +
    lambda_train * dL_train/da``."""
    arch, weights = split_arch(params)
    w = {k: v.detach() for k, v in weights.items()}

    def grad_at(batch):
        a = _leaves(arch)
        return torch.autograd.grad(loss_fn(merge_arch(a, w), batch),
                                   list(a.values()))

    g_tr, g_val = grad_at(train_batch), grad_at(val_batch)
    return {k: lambda_valid * gv + lambda_train * gt
            for k, gv, gt in zip(arch, g_val, g_tr)}


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

def cosine_lr(lr: float, total_steps: int, alpha: float,
              step: int) -> float:
    """optax's ``cosine_decay_schedule(lr, total_steps, alpha)`` at
    ``step``, each operation rounded to float32 as the reference's jitted
    schedule rounds it."""
    f32 = np.float32
    count = f32(min(int(step), int(total_steps)))
    x = f32(f32(f32(math.pi) * count) / f32(total_steps))
    cosine = f32(f32(0.5) * f32(f32(1.0) + f32(np.cos(x))))
    decayed = f32(f32(f32(1.0 - alpha) * cosine) + f32(alpha))
    return float(f32(f32(lr) * decayed))


def _sgd_step(params: dict, grads: dict, trace: dict, lr: float,
              clip: float, wd: float, momentum: float) -> None:
    """The weight step in optax's order (global-norm clip, ``+ wd * w``,
    the momentum trace, ``-lr``), in place: the fused CUDA step on CUDA
    tensors, the plain chain on CPU tensors."""
    names = list(params)
    fused_sgd_step([params[k] for k in names], [grads[k] for k in names],
                   [trace[k] for k in names], None, clip=clip, wd=wd,
                   momentum=momentum, lr=lr)


class ArchAdam:
    """The architect's optimizer: ``+ wd * a``, ``scale_by_adam`` (b1 0.5,
    b2 0.999, eps 1e-8, bias-corrected by the step count), ``* -lr``, each
    operation rounded on its own in optax's order."""

    B1, B2, EPS = 0.5, 0.999, 1e-8

    def __init__(self, arch: dict, lr: float, weight_decay: float):
        self.mu = {k: torch.zeros_like(v) for k, v in arch.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in arch.items()}
        self.count, self.lr, self.wd = 0, lr, weight_decay

    @torch.no_grad()
    def step(self, arch: dict, grads: dict) -> None:
        f32 = np.float32
        self.count += 1
        bc1 = _bias_correction(self.B1, self.count)
        bc2 = _bias_correction(self.B2, self.count)
        c1, c2 = float(f32(1 - self.B1)), float(f32(1 - self.B2))
        for k, a in arch.items():
            g = grads[k] + self.wd * a
            self.mu[k] = c1 * g + self.B1 * self.mu[k]
            self.nu[k] = c2 * (g ** 2) + self.B2 * self.nu[k]
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.EPS)
            a.copy_(a + u * (-self.lr))


class DartsSearch:
    """The bilevel search driver: per batch one architect step (Adam on the
    alphas from the validation batch's gradient, or under ``unrolled`` the
    exact unrolled gradient at the current lr and momentum trace), then one
    SGD step of the weights on the training batch. The reference's
    defaults: weight lr 0.025 cosine-annealed to ``lr_min`` 0.001,
    momentum 0.9, wd 3e-4, clip 5; arch lr 3e-4, wd 1e-3. Batches are
    ``(x NCHW, y)``. The state (``init``) is updated in place."""

    def __init__(self, net: DartsSearchNet, num_classes: int,
                 lr: float = 0.025, lr_min: float = 0.001,
                 momentum: float = 0.9, weight_decay: float = 3e-4,
                 grad_clip: float = 5.0, arch_lr: float = 3e-4,
                 arch_weight_decay: float = 1e-3, unrolled: bool = False,
                 total_steps: int = 1000):
        if net.gumbel:
            raise ValueError(
                "DartsSearch drives the softmax supernet; for GDAS apply "
                "the gumbel=True net directly with its Gumbel draws")
        self.net, self.num_classes, self.unrolled = net, num_classes, unrolled
        self.lr, self.alpha, self.total = lr, lr_min / lr, total_steps
        self.momentum, self.weight_decay = momentum, weight_decay
        self.grad_clip = grad_clip
        self.arch_lr, self.arch_wd = arch_lr, arch_weight_decay

    def loss_fn(self, params: dict, batch) -> torch.Tensor:
        x, y = batch
        return softmax_ce(functional_call(self.net, params, (x,),
                                          {"train": True}), y)

    def init(self, generator: torch.Generator, params: dict | None = None
             ) -> dict:
        """The state: ``params`` (drawn from ``generator`` on the CPU and
        moved to the net's device where not given), the zero momentum
        trace of the weights, the architect's Adam, the step 0."""
        if params is None:
            dev = self.net.alphas_normal.device
            self.net.to("cpu").reset_parameters(generator)
            self.net.to(dev)
            params = {k: v.detach().clone()
                      for k, v in self.net.named_parameters()}
        arch, weights = split_arch(params)
        return {"params": params,
                "trace": {k: torch.zeros_like(v) for k, v in weights.items()},
                "a_opt": ArchAdam(arch, self.arch_lr, self.arch_wd),
                "step": 0}

    def step(self, state: dict, train_batch, val_batch):
        """One bilevel update in place; returns ``(state, train loss)``."""
        arch, weights = split_arch(state["params"])
        eta = cosine_lr(self.lr, self.total, self.alpha, state["step"])
        if self.unrolled:
            g_a = arch_grad_unrolled(self.loss_fn, state["params"],
                                     train_batch, val_batch, eta,
                                     self.momentum, self.weight_decay,
                                     state["trace"])
        else:
            a = _leaves(arch)
            w = {k: v.detach() for k, v in weights.items()}
            g = torch.autograd.grad(
                self.loss_fn(merge_arch(a, w), val_batch), list(a.values()))
            g_a = dict(zip(a, g))
        state["a_opt"].step(arch, g_a)
        w = _leaves(weights)
        a = {k: v.detach() for k, v in arch.items()}
        loss = self.loss_fn(merge_arch(a, w), train_batch)
        g_w = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))
        with torch.no_grad():
            _sgd_step(weights, g_w, state["trace"], eta, self.grad_clip,
                      self.weight_decay, self.momentum)
        state["step"] += 1
        return state, loss.detach()

    def genotype(self, state: dict) -> Genotype:
        arch, _ = split_arch(state["params"])
        return derive_genotype(arch["alphas_normal"], arch["alphas_reduce"],
                               self.net.steps, self.net.multiplier)


class DartsTrainer:
    """The evaluation-phase trainer of a ``DartsNetwork``: cross-entropy
    plus ``aux_weight`` (0.4) times the auxiliary head's, global-norm clip
    5, SGD momentum 0.9, wd 3e-4, the lr cosine-annealed to 0 over
    ``total_steps``, and drop-path at ``drop_path_prob * min(step / total,
    1)`` on every non-identity edge, drawn even at 0; the BatchNorm
    running stats move every step. Batches are ``(x NCHW, y)``; the state
    (``init``) is updated in place."""

    def __init__(self, net: DartsNetwork, num_classes: int,
                 lr: float = 0.025, momentum: float = 0.9,
                 weight_decay: float = 3e-4, grad_clip: float = 5.0,
                 aux_weight: float = 0.4, drop_path_prob: float = 0.2,
                 total_steps: int = 1000):
        self.net, self.num_classes = net, num_classes
        self.lr, self.momentum, self.weight_decay = lr, momentum, weight_decay
        self.grad_clip, self.aux_weight = grad_clip, aux_weight
        self.drop_path_prob, self.total = drop_path_prob, total_steps

    def init(self, generator: torch.Generator, params: dict | None = None,
             bstats: dict | None = None) -> dict:
        """The state: ``params`` / ``bstats`` (drawn from ``generator`` on
        the CPU and moved to the net's device where not given), the zero
        momentum trace, the step 0."""
        if params is None:
            dev = self.net.Dense_0.weight.device
            self.net.to("cpu").reset_parameters(generator)
            self.net.to(dev)
            params = {k: v.detach().clone()
                      for k, v in self.net.named_parameters()}
            bstats = {k: v.clone() for k, v in self.net.named_buffers()}
        return {"params": params, "bstats": bstats,
                "trace": {k: torch.zeros_like(v) for k, v in params.items()},
                "step": 0}

    def drop_prob(self, step: int) -> float:
        """``drop_path_prob * min(step / total, 1)`` in float32."""
        f32 = np.float32
        frac = min(f32(f32(step) / f32(self.total)), f32(1.0))
        return float(f32(f32(self.drop_path_prob) * frac))

    def step(self, state: dict, batch, generator: torch.Generator | None
             = None, drop_path_masks=None):
        """One training step in place; the keep-masks are
        ``drop_path_masks`` or drawn from ``generator``. Returns
        ``(state, loss)``."""
        x, y = batch
        dpp = self.drop_prob(state["step"])
        if drop_path_masks is None:
            drop_path_masks = keep_masks(self.net.drop_path_edges(),
                                         x.shape[0], dpp, generator, x.device)
        p = _leaves(state["params"])
        logits, aux = functional_call(
            self.net, (p, state["bstats"]), (x,),
            {"train": True, "drop_path_prob": dpp,
             "drop_path_masks": drop_path_masks})
        loss = softmax_ce(logits, y)
        if aux is not None:
            loss = loss + self.aux_weight * softmax_ce(aux, y)
        g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        lr = cosine_lr(self.lr, self.total, 0.0, state["step"])
        with torch.no_grad():
            _sgd_step(state["params"], g, state["trace"], lr, self.grad_clip,
                      self.weight_decay, self.momentum)
        state["step"] += 1
        return state, loss.detach()
