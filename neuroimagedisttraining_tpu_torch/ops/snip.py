"""SNIP saliency and the global mask (SalientGrads phase 1).

The saliency of a weight is ``|w * dL/dw|`` on a training batch (the
gradient of the loss with respect to a multiplicative mask at 1). IterSNIP
averages it over ``iterations`` batches drawn from the client's valid
rows. The server averages the clients' scores, normalizes them by
their global sum and keeps the top ``keep_ratio`` fraction across all
layers, with the threshold from the histogram-select of ``ops/topk.py``.
With ``stratified_sampling`` the IterSNIP batches are label-balanced.
"""

from __future__ import annotations

import math

import torch

from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
from neuroimagedisttraining_tpu_torch.ops.masks import is_weight_kernel
from neuroimagedisttraining_tpu_torch.ops.topk import kth_largest

State = dict[str, torch.Tensor]


def snip_scores(trainer: LocalTrainer, params: State, bstats: State,
                x: torch.Tensor, y: torch.Tensor) -> State:
    """``|w * grad|`` on one batch; zeros for non-maskable leaves."""
    _, grads, _ = trainer.loss_and_grad(params, bstats, x, y)
    return {k: torch.abs(params[k] * g) if is_weight_kernel(k, g)
            else torch.zeros_like(g) for k, g in grads.items()}


def iter_snip_batch_indices(generator: torch.Generator, iterations: int,
                            batch_size: int, n_valid: int,
                            device: torch.device) -> torch.Tensor:
    """[iterations, batch_size] uniform row indices in ``[0, n_valid)``."""
    return torch.randint(0, max(int(n_valid), 1), (iterations, batch_size),
                         generator=generator, device=device)


def stratified_batch_indices(generator: torch.Generator, y: torch.Tensor,
                             iterations: int, batch_size: int,
                             n_valid: int) -> torch.Tensor:
    """[iterations, batch_size] label-balanced draws with replacement:
    each valid row weighs ``1 / count(its label)`` among the valid rows,
    so every class is drawn with equal expected frequency."""
    valid = torch.arange(y.shape[0], device=y.device) < int(n_valid)
    eq = (y[None, :] == y[:, None]) & valid[None, :]
    cnt = eq.sum(dim=1)
    w = torch.where(valid, 1.0 / torch.clamp(cnt, min=1),
                    torch.zeros((), device=y.device))
    return torch.multinomial(w, iterations * batch_size, replacement=True,
                             generator=generator
                             ).reshape(iterations, batch_size)


def iter_snip_scores(trainer: LocalTrainer, params: State, bstats: State,
                     X: torch.Tensor, y: torch.Tensor, n_valid: int,
                     iterations: int, batch_size: int,
                     stratified: bool = False,
                     idx_stack: torch.Tensor | None = None) -> State:
    """Mean saliency over ``iterations`` batches, drawn uniformly from the
    valid rows or label-balanced when ``stratified`` (``idx_stack`` gives
    the batch rows; drawn from the trainer's generator when None)."""
    if idx_stack is None and stratified:
        idx_stack = stratified_batch_indices(trainer.generator, y,
                                             iterations, batch_size, n_valid)
    elif idx_stack is None:
        idx_stack = iter_snip_batch_indices(trainer.generator, iterations,
                                            batch_size, n_valid,
                                            trainer.device)
    total = {k: torch.zeros_like(v) for k, v in params.items()}
    for idx in idx_stack.to(trainer.device):
        s = snip_scores(trainer, params, bstats, X[idx], y[idx])
        total = {k: total[k] + s[k] for k in total}
    return {k: t / iterations for k, t in total.items()}


def mask_from_scores(scores: State, keep_ratio: float
                     ) -> tuple[State, torch.Tensor]:
    """Global top-``keep_ratio`` mask over the maskable leaves of the
    normalized scores, ones elsewhere; returns ``(masks, threshold)``.

    Raises ``FloatingPointError`` on non-finite scores, on all-zero scores,
    and on a non-finite threshold, rather than building a wrong mask. The
    three checks read the device once."""
    parts = [s.reshape(-1) for k, s in scores.items()
             if is_weight_kernel(k, s)]
    all_scores = torch.cat(parts)
    norm = torch.sum(all_scores)
    # counted on the RAW scores: after /norm one NaN poisons every entry
    bad = torch.sum(~torch.isfinite(all_scores))
    k = max(1, int(all_scores.numel() * keep_ratio))
    threshold = kth_largest(all_scores / norm, k)
    norm_h, bad_h, thr_h = torch.stack(
        [norm, bad.to(norm.dtype), threshold]).tolist()
    if not math.isfinite(norm_h):
        raise FloatingPointError(
            f"SNIP saliency scores contain {int(bad_h)} non-finite entries "
            "(or their sum overflows): refusing to build the global mask. "
            "Check the phase-1 loss of each client for divergence.")
    if norm_h == 0:
        raise FloatingPointError(
            "SNIP saliency scores are identically zero: no signal to rank "
            "- the phase-1 gradient probe produced zero gradients for every "
            "maskable weight (dead activations? zero init?).")
    if not math.isfinite(thr_h):
        raise FloatingPointError(
            f"global top-k threshold is non-finite ({int(bad_h)} non-finite "
            "raw saliency scores): refusing to build the global mask. Check "
            "the phase-1 loss of each client for divergence.")
    masks = {k: ((s / norm) >= threshold).to(torch.float32)
             if is_weight_kernel(k, s) else torch.ones_like(s)
             for k, s in scores.items()}
    return masks, threshold
