"""Sparse masks: dicts congruent with ``params``, float 0/1 on the maskable
leaves (conv and dense weights) and ones elsewhere.

DisPFL's mask machinery:

- ``calculate_sparsities``: each maskable layer's target sparsity, ERK
  (Erdos-Renyi-Kernel, with the loop that makes a layer dense where its
  density would pass 1) or uniform.
- ``init_masks``: random masks with exactly ``int((1 - s) * numel)`` ones
  per maskable layer, from an explicit ``torch.Generator``.
- ``fire_mask``: drops the ``ceil(drop_ratio * nnz)`` smallest-|w| alive
  entries of each layer, ``drop_ratio`` annealed on a cosine over the run.
- ``regrow_mask``: as many entries back on the dead ones, by the largest
  |gradient| or at random.

Both rank with a stable sort, so tied entries (dead entries at the fire
sentinel, exact-zero gradients of ReLU-dead units) go in index order: the
order of the reference's layouts (a conv weight flattened DHWIO or HWIO,
a dense one [in, out]), so that the same entries fire and regrow. The drop counts
stay on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

State = dict[str, torch.Tensor]

#: the score of an entry that ``fire_mask`` / ``regrow_mask`` must not pick
_SENTINEL = 1e5


def is_weight_kernel(name: str, leaf: torch.Tensor) -> bool:
    """Maskable leaf: a conv or dense weight (not a bias or a BN scale)."""
    return name.endswith("weight") and leaf.dim() >= 2


def ones_mask(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: torch.ones_like(v) for k, v in params.items()}


def mask_density(masks: dict[str, torch.Tensor]) -> torch.Tensor:
    """Fraction of kept entries over the maskable leaves."""
    kept = [m.sum() for k, m in masks.items() if is_weight_kernel(k, m)]
    size = sum(m.numel() for k, m in masks.items() if is_weight_kernel(k, m))
    return sum(kept) / max(size, 1)


def maskable_names(params: State) -> list[str]:
    """The maskable leaves' names in the reference's leaf order: its
    parameter tree sorted by module path (``f0/conv/kernel``, ...)."""
    return sorted((k for k, v in params.items() if is_weight_kernel(k, v)),
                  key=lambda k: tuple(k.split(".")[:-1]))


def calculate_sparsities(params: State, distribution: str = "ERK",
                         dense_ratio: float = 0.5,
                         erk_power_scale: float = 1.0,
                         tabu: tuple[str, ...] = ()) -> dict[str, float]:
    """Target sparsity of each maskable leaf, by name.

    ERK: ``1 - eps * (sum(shape) / prod(shape)) ** erk_power_scale``, with
    ``eps`` solved so that the layers keep ``dense_ratio`` of their
    weights; a layer whose density would pass 1 is made dense and ``eps``
    solved again. The float64 sums run in the reference's leaf order, so
    they round as its do. Uniform: ``1 - dense_ratio`` (0 in ``tabu``)."""
    shapes = {k: tuple(params[k].shape) for k in maskable_names(params)}
    if distribution == "uniform":
        return {k: 0.0 if k in tabu else 1.0 - dense_ratio for k in shapes}
    if distribution != "ERK":
        raise ValueError(f"unknown distribution {distribution!r}")
    dense_layers = {t for t in tabu if t in shapes}
    while True:
        divisor, rhs = 0.0, 0.0
        raw: dict[str, float] = {}
        for name, shape in shapes.items():
            n_param = float(math.prod(shape))
            if name in dense_layers:
                rhs -= n_param * (1.0 - dense_ratio)
            else:
                rhs += n_param * dense_ratio
                raw[name] = (float(sum(shape)) / n_param) ** erk_power_scale
                divisor += raw[name] * n_param
        epsilon = rhs / divisor
        max_prob = max(raw.values())
        if max_prob * epsilon <= 1:
            break
        dense_layers |= {k for k, p in raw.items() if p == max_prob}
    return {k: 0.0 if k in dense_layers else 1.0 - epsilon * raw[k]
            for k in shapes}


def init_masks(generator: torch.Generator, params: State,
               sparsities: dict[str, float]) -> State:
    """Random 0/1 masks with exactly ``int((1 - s) * numel)`` ones on each
    leaf of ``sparsities`` (a permutation from ``generator`` picks them,
    leaf by leaf in the reference's order), ones elsewhere."""
    out = {k: torch.ones_like(v) for k, v in params.items()}
    for name in maskable_names(params):
        if name not in sparsities:
            continue
        leaf = params[name]
        keep = int((1.0 - sparsities[name]) * leaf.numel())
        perm = torch.randperm(leaf.numel(), generator=generator,
                              device=generator.device).to(leaf.device)
        flat = torch.zeros(leaf.numel(), dtype=leaf.dtype, device=leaf.device)
        flat[perm[:keep]] = 1
        out[name] = flat.reshape(leaf.shape)
    return out


def reference_flat(x: torch.Tensor) -> torch.Tensor:
    """``x`` flattened in the reference's layout: a conv weight OIDHW as
    DHWIO, OIHW as HWIO, a dense weight [out, in] as [in, out]."""
    if x.dim() == 5:
        x = x.permute(2, 3, 4, 1, 0)
    elif x.dim() == 4:
        x = x.permute(2, 3, 1, 0)
    elif x.dim() == 2:
        x = x.t()
    return x.reshape(-1)


def from_reference_flat(flat: torch.Tensor, like: torch.Tensor
                        ) -> torch.Tensor:
    """The inverse of :func:`reference_flat`, in ``like``'s shape."""
    if like.dim() == 5:
        o, i, d, h, w = like.shape
        return flat.reshape(d, h, w, i, o).permute(4, 3, 0, 1, 2).contiguous()
    if like.dim() == 4:
        o, i, h, w = like.shape
        return flat.reshape(h, w, i, o).permute(3, 2, 0, 1).contiguous()
    if like.dim() == 2:
        return flat.reshape(like.shape[1], like.shape[0]).t().contiguous()
    return flat.reshape(like.shape)


def rank_of(values: torch.Tensor, descending: bool = False) -> torch.Tensor:
    """``rank[i]``: the position of entry ``i`` of flat ``values`` in its
    stable sort (ties in index order; descending sorts ``-values``)."""
    order = torch.argsort(-values if descending else values, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    return rank


def drop_ratio(round_idx: int, comm_round: int,
               anneal_factor: float) -> torch.Tensor:
    """``anneal / 2 * (1 + cos(round * pi / comm_round))`` as a 0-d
    float32 tensor on the host: each operation rounded in float32 and the
    cosine correctly rounded (taken in float64), as the reference computes
    it run op by op; ``torch.cos`` can be an ulp off, which moves a drop
    count by one where ``drop_ratio * nnz`` lies next to an integer."""
    f32 = np.float32
    x = f32(f32(round_idx) * f32(math.pi)) / f32(comm_round)
    cos = f32(math.cos(float(x)))
    return torch.tensor(f32(anneal_factor / 2.0) * (f32(1.0) + cos))


def fire_mask(masks: State, weights: State, round_idx: int, comm_round: int,
              anneal_factor: float = 0.5) -> tuple[State, State]:
    """Drop ``k = ceil(drop_ratio * nnz)`` alive entries of the smallest
    |w| from each maskable layer. Returns ``(masks, k by layer)``, the
    counts as 0-d int64 device tensors."""
    ratio = drop_ratio(round_idx, comm_round, anneal_factor)
    out, num_remove = {}, {}
    for name, m in masks.items():
        if not is_weight_kernel(name, m):
            out[name] = m
            continue
        flat = reference_flat(m)
        k = torch.ceil(ratio * flat.sum()).to(torch.int64)
        num_remove[name] = k
        score = torch.where(flat > 0, reference_flat(weights[name]).abs(),
                            torch.full_like(flat, _SENTINEL))
        keep = (rank_of(score) >= k).to(m.dtype) * flat
        out[name] = from_reference_flat(keep, m)
    return out, num_remove


def regrow_mask(masks: State, num_remove: State, gradient: State | None,
                generator: torch.Generator | None = None,
                dis_gradient_check: bool = False) -> State:
    """Regrow ``num_remove[name]`` dead entries of each layer: those of the
    largest |gradient|, or under ``dis_gradient_check`` those of the
    largest uniform draw from ``generator``."""
    out = {}
    for name, m in masks.items():
        if name not in num_remove:
            out[name] = m
            continue
        flat = reference_flat(m)
        if dis_gradient_check:
            value = torch.rand(flat.shape, generator=generator,
                               device=generator.device).to(flat.device)
        else:
            value = reference_flat(gradient[name]).abs()
        score = torch.where(flat == 0, value, torch.full_like(flat, -_SENTINEL))
        grow = rank_of(score, descending=True) < num_remove[name]
        out[name] = from_reference_flat(
            torch.where(grow, torch.ones_like(flat), flat), m)
    return out


def mask_hamming_distance(a: State, b: State) -> torch.Tensor:
    """The count of differing entries over every leaf (a float32 0-d
    tensor)."""
    return torch.stack([torch.sum(torch.abs(x - b[k]))
                        for k, x in a.items()]).sum()


def mask_nnz(masks: State) -> torch.Tensor:
    """Kept entries over the maskable leaves (a 0-d device tensor)."""
    return sum(torch.count_nonzero(m) for k, m in masks.items()
               if is_weight_kernel(k, m))
