"""Sub-FedAvg's iterative magnitude pruning.

- ``fake_prune``: per maskable layer, the ``each_prune_ratio`` quantile of
  |w| over the entries the mask keeps becomes a threshold, and every entry
  whose |w| lies below it leaves the mask. The comparison is against the
  full tensor, so entries already dead stay dead; an empty alive set
  leaves the mask as it is. The quantile is numpy's linear interpolation
  between order statistics, each operation rounded on its own in float32
  (:func:`percentile_alive`).
- ``mask_distance_mean``: the mean over maskable layers of the fraction of
  entries on which two masks differ (scipy's Hamming distance).
- ``density_all_leaves``: nonzero entries over every entry of every leaf
  (biases and BatchNorm parameters included; a bias exactly 0 counts as
  zero).

Everything stays on the tensors' device: the alive count, the quantile and
the threshold are device scalars.
"""

from __future__ import annotations

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.ops.masks import (
    is_weight_kernel, maskable_names,
)

State = dict[str, torch.Tensor]


def percentile_alive(absw: torch.Tensor, mask: torch.Tensor, ratio: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(threshold, n_alive)`` for flat ``absw`` and ``mask``: the
    ``ratio`` quantile of ``absw`` over the entries where ``mask > 0``,
    with numpy's linear interpolation: ``q = ratio * (n_alive - 1)``,
    ``v_lo + frac * (v_hi - v_lo)`` between the order statistics at
    ``floor(q)`` and the next one, in float32."""
    alive = mask > 0
    n_alive = alive.sum(dtype=torch.int32)
    srt = torch.sort(torch.where(alive, absw, torch.inf)).values
    last = absw.numel() - 1
    # the ratio as a float32 host scalar: no copy to the device
    q = torch.tensor(ratio, dtype=torch.float32) * (
        n_alive.to(torch.float32) - 1.0)
    lo = torch.clamp(torch.floor(q).to(torch.int32), 0, last)
    hi = torch.clamp(lo + 1, 0, last)
    frac = q - lo.to(torch.float32)
    # gathered by a one-element index tensor: indexing with a 0-d tensor
    # would read it on the host
    v_lo = srt.index_select(0, lo.reshape(1)).reshape(())
    v_hi = torch.where(hi < n_alive,
                       srt.index_select(0, hi.reshape(1)).reshape(()), v_lo)
    return v_lo + frac * (v_hi - v_lo), n_alive


def fake_prune(each_prune_ratio: float, params: State, masks: State) -> State:
    """The candidate next masks: the bottom ``each_prune_ratio`` of the
    alive |w| of each maskable layer dropped; other leaves keep their
    mask."""
    out = {}
    for name, m in masks.items():
        if not is_weight_kernel(name, m):
            out[name] = m
            continue
        absw = params[name].reshape(-1).abs()
        flat = m.reshape(-1)
        thr, n_alive = percentile_alive(absw, flat, each_prune_ratio)
        new = torch.where(absw < thr, torch.zeros_like(flat), flat)
        out[name] = torch.where(n_alive > 0, new, flat).reshape(m.shape)
    return out


def _mean(total: torch.Tensor, n: int) -> torch.Tensor:
    """``total / n`` as the reference's float32 mean rounds it: times the
    float32 reciprocal of ``n``."""
    return total * torch.tensor(np.float32(1.0) / np.float32(n))


def mask_distance_mean(m1: State, m2: State) -> torch.Tensor:
    """Mean over maskable layers (summed in the reference's leaf order) of
    each layer's fraction of differing entries."""
    fracs = [_mean(torch.sum(torch.abs(m1[k] - m2[k])), m1[k].numel())
             for k in maskable_names(m1)]
    total = fracs[0]
    for f in fracs[1:]:
        total = total + f
    return _mean(total, len(fracs))


def density_all_leaves(params: State) -> torch.Tensor:
    """Nonzero entries over all entries, over every leaf (float32)."""
    nz = sum(torch.count_nonzero(x) for x in params.values())
    total = sum(x.numel() for x in params.values())
    return nz.to(torch.float32) / total
