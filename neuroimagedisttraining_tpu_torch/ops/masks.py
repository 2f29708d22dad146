"""Sparse masks: dicts congruent with ``params``, float 0/1 on the maskable
leaves (conv and dense weights) and ones elsewhere."""

from __future__ import annotations

import torch


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
