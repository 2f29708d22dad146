"""Losses and evaluation metrics: BCE-with-logits for the ABCD binary task
(one logit) and integer-label softmax cross-entropy for ``num_classes > 1``
(each a weighted mean over valid rows), hard predictions (logit > 0, or the
argmax), and the exact pairwise ROC-AUC."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean binary cross-entropy; with ``weights``, the weighted mean
    ``sum(per * w) / max(sum(w), 1e-9)``."""
    z = logits.reshape(-1)
    y = labels.reshape(-1).to(torch.float32)
    per = -y * F.logsigmoid(z) - (1 - y) * F.logsigmoid(-z)
    if weights is None:
        return per.mean()
    w = weights.reshape(-1).to(torch.float32)
    return torch.sum(per * w) / torch.clamp(torch.sum(w), min=1e-9)


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor,
               weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean integer-label cross-entropy of ``[B, K]`` logits
    (``-log_softmax(logits)[label]``); with ``weights`` the weighted mean
    as :func:`bce_with_logits` takes it."""
    per = -torch.gather(F.log_softmax(logits, dim=-1), -1,
                        labels.reshape(-1, 1).to(torch.int64))[:, 0]
    if weights is None:
        return per.mean()
    w = weights.reshape(-1).to(torch.float32)
    return torch.sum(per * w) / torch.clamp(torch.sum(w), min=1e-9)


def make_loss(num_classes: int):
    """One logit: BCE-with-logits (ABCD); more: softmax cross-entropy."""
    return bce_with_logits if num_classes == 1 else softmax_ce


def predictions(logits: torch.Tensor, num_classes: int = 1) -> torch.Tensor:
    """Hard predictions: sigmoid > 0.5 (logit > 0) for one logit, else the
    argmax (the first of tied maxima)."""
    if num_classes == 1:
        return (logits.reshape(-1) > 0.0).to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def binary_auc(scores: torch.Tensor, labels: torch.Tensor,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """Exact pairwise ROC-AUC (Mann-Whitney U with 0.5 credit for ties)
    over the valid rows; 0.5 when one class is absent."""
    s = scores.reshape(-1).to(torch.float32)
    y = labels.reshape(-1).to(torch.int32)
    v = (torch.ones_like(s) if valid is None
         else valid.reshape(-1).to(torch.float32))
    pos = (y == 1).to(torch.float32) * v
    neg = (y == 0).to(torch.float32) * v
    gt = (s[:, None] > s[None, :]).to(torch.float32)
    eq = (s[:, None] == s[None, :]).to(torch.float32)
    wins = torch.einsum("i,ij,j->", pos, gt + 0.5 * eq, neg)
    denom = torch.sum(pos) * torch.sum(neg)
    return torch.where(denom > 0, wins / torch.clamp(denom, min=1.0),
                       torch.full_like(wins, 0.5))
