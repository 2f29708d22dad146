"""The local optimizers with the reference's semantics.

SGD: global-norm clip, then ``g + wd * p``, then momentum
``t = g + m * t``, then ``p += -lr * t`` (lr applied after momentum, as
``torch.optim.SGD`` does), then the sparse mask ``p *= mask``.
``fused_update=False`` runs the chain as plain PyTorch operations
(``ops.fused_update.sgd_step_plain``); ``fused_update=True`` runs it as the
fused CUDA step, the global norm and then one pass over every leaf
(``ops.fused_update.fused_sgd_step``, which takes the same plain path for
CPU tensors).

Adam (``client_optimizer="adam"``), the reference's optax chain: the
global-norm clip, then ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8,
bias correction by the step count), then ``+ wd * p``, then
``p += -lr * u``, then the mask. It is plain PyTorch operations, each
rounded on its own, in the reference's order (``torch.optim.Adam`` rounds
in another order). It has no fused kernel: ``fused_update`` with Adam is
refused, as the reference refuses it.

Both update in place. The optimizer state (momentum buffers, Adam's
moments and count) starts at zero every round (the reference builds a
fresh optimizer per round).

The precision contract, as the reference's: ``OptimConfig.precision``
picks the compute dtype of a training step only. Under ``bf16_mixed`` the
model's convolutions, dense layers and activations run in bfloat16, while
the parameters (master weights), the optimizer state, the loss, the
gradients the optimizer sees, the BatchNorm running stats and everything
outside the step (FedAvg, every engine's planes) stay float32. A fixed
``loss_scale`` multiplies the float32 loss before the gradient and
divides the float32 gradients after it; it is pinned to 1 (no operation
at all) under fp32, so the fp32 path is unchanged.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.config import OptimConfig
from neuroimagedisttraining_tpu_torch.ops.fused_update import (
    fused_sgd_step, sgd_scalars, sgd_step_plain,
)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

#: legal ``OptimConfig.precision`` values
PRECISIONS = ("fp32", "bf16_mixed")

#: ``--remat auto``: the samples in flight above which stem remat arms, by
#: precision. Clients train one after another, so the samples in flight
#: are one client's batch. The card's own cutoff (``chip_smoke.py``'s
#: memory phase on an H100 80GB HBM3 at 700 W, PERF.md): the flagship's
#: training step peaks at 0.325 GB a sample in fp32 and 0.321 GB in
#: bf16_mixed above 0.63 GB allocated, so a batch of up to 233 (236) stays
#: within 90% of the card's 85.0 GB without remat. Stem remat does not
#: lower that peak (the stem block's own backward sets it) and costs a
#: third more time a step, so below the cutoff it is never armed.
REMAT_AUTO_SAMPLES = {"fp32": 233, "bf16_mixed": 236}


def validate_precision_name(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; choose one of {PRECISIONS}")


def compute_dtype(precision: str) -> torch.dtype:
    """The models' compute dtype under a precision policy (the parameters
    stay float32 either way)."""
    validate_precision_name(precision)
    return torch.bfloat16 if precision == "bf16_mixed" else torch.float32


def resolve_remat(remat: str, precision: str, batch_size: int):
    """A ``--remat`` choice as the models take it: ``none`` False, ``stem``
    ``"stem"``, ``all`` True; ``auto`` stem remat once a batch passes
    :data:`REMAT_AUTO_SAMPLES` of its precision, else none."""
    validate_precision_name(precision)
    if remat == "auto":
        return (False if batch_size <= REMAT_AUTO_SAMPLES[precision]
                else "stem")
    choices = {"none": False, "stem": "stem", "all": True}
    if remat not in choices:
        raise ValueError(f"unknown remat {remat!r}; choose auto, "
                         f"{', '.join(choices)}")
    return choices[remat]


def validate_precision(cfg: OptimConfig) -> None:
    """The precision contract, checked where a trainer is built: a known
    ``precision``; ``loss_scale`` positive and finite (it divides the
    gradients); a scale other than 1 only under ``bf16_mixed`` (under fp32
    the pair would only perturb rounding); ``fused_update`` only for the
    SGD chain."""
    validate_precision_name(cfg.precision)
    scale = float(cfg.loss_scale)
    if not (scale > 0 and math.isfinite(scale)):
        raise ValueError(f"loss_scale must be a positive finite constant "
                         f"(got {cfg.loss_scale!r})")
    if scale != 1.0 and cfg.precision != "bf16_mixed":
        raise ValueError(
            f"loss_scale={cfg.loss_scale} needs precision=bf16_mixed: "
            "under fp32 the scale/unscale pair would only perturb "
            "rounding and break the bitwise-f32 contract")
    if cfg.fused_update and cfg.client_optimizer != "sgd":
        raise ValueError(
            "--fused_update fuses the SGD clip/momentum/update tail "
            f"(ops/fused_update.py); client_optimizer="
            f"{cfg.client_optimizer!r} has no fused kernel and would "
            "silently train un-fused")


class AdamState:
    """Adam's first and second moments (lists of leaves, or dicts by leaf
    name) and the number of steps taken, which every step advances."""

    def __init__(self, mu, nu, count: int = 0):
        self.mu, self.nu, self.count = mu, nu, count


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32 as the reference's jitted power
    rounds it (the power of float32 ``decay`` rounded once)."""
    power = np.float32(np.float64(np.float32(decay)) ** count)
    return float(np.float32(np.float32(1.0) - power))


def adam_step_plain(params, grads, state: AdamState, mask, *, clip: float,
                    wd: float, lr) -> None:
    """One Adam step over lists of leaves, in place on ``params`` and
    ``state``: the clip under :func:`sgd_scalars`, ``mu = (1 - b1) * g +
    b1 * mu``, ``nu = (1 - b2) * g^2 + b2 * nu``, ``u = (mu / bc1) /
    (sqrt(nu / bc2) + eps)``, ``u + wd * p``, ``p + (-lr) * u``, ``p *
    mask``, each operation rounded on its own."""
    scal = sgd_scalars(grads, clip=clip, lr=lr)
    ok, gnorm, lr_t = scal[0] > 0.5, scal[1], scal[2]
    state.count += 1
    c1 = float(np.float32(1 - ADAM_B1))
    c2 = float(np.float32(1 - ADAM_B2))
    bc1 = _bias_correction(ADAM_B1, state.count)
    bc2 = _bias_correction(ADAM_B2, state.count)
    for i, (p, g) in enumerate(zip(params, grads)):
        if clip > 0:
            g = torch.where(ok, g, (g / gnorm) * clip)
        mu = c1 * g + ADAM_B1 * state.mu[i]
        nu = c2 * (g * g) + ADAM_B2 * state.nu[i]
        state.mu[i].copy_(mu)
        state.nu[i].copy_(nu)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        if wd > 0:
            u = u + wd * p
        p_new = p + (-lr_t) * u
        if mask is not None:
            p_new = p_new * mask[i]
        p.copy_(p_new)


class LocalOptimizer:
    """The SGD or Adam chain of one config, over lists of parameter
    leaves."""

    def __init__(self, cfg: OptimConfig):
        if cfg.client_optimizer not in ("sgd", "adam"):
            raise ValueError(f"unknown client_optimizer "
                             f"{cfg.client_optimizer!r}")
        validate_precision(cfg)  # refuses fused_update with Adam
        self.cfg = cfg
        self.adam = cfg.client_optimizer == "adam"

    def init(self, params: list[torch.Tensor]):
        """The zero state: Adam's :class:`AdamState`, else SGD's momentum
        buffers (None when momentum is 0)."""
        if self.adam:
            return AdamState([torch.zeros_like(p) for p in params],
                             [torch.zeros_like(p) for p in params])
        if self.cfg.momentum <= 0:
            return None
        return [torch.zeros_like(p) for p in params]

    def step(self, params, grads, state, lr, mask=None) -> None:
        """One in-place step: Adam's plain chain; for SGD the fused kernel
        (the reference's ``fused_apply``) under ``fused_update``, else the
        plain chain."""
        c = self.cfg
        if self.adam:
            adam_step_plain(params, grads, state, mask, clip=c.grad_clip,
                            wd=c.wd, lr=lr)
            return
        fn = fused_sgd_step if c.fused_update else sgd_step_plain
        fn(params, grads, state, mask, clip=c.grad_clip, wd=c.wd,
           momentum=c.momentum, lr=lr)


def round_lr(cfg: OptimConfig, round_idx: int,
             device: torch.device) -> torch.Tensor:
    """``lr * lr_decay ** round`` in float32 as a 0-d device tensor; the
    power is taken by repeated squaring in float32, as the reference's
    integer power is, and a negative round takes the reciprocal of the
    power of its magnitude (FedAvg's final fine-tune runs at round -1,
    i.e. ``lr / lr_decay``)."""
    y = abs(int(round_idx))
    x = np.float32(cfg.lr_decay)
    acc = np.float32(1.0)
    first = True
    while y > 0:
        if y & 1:
            acc = x if first else np.float32(acc * x)
            first = False
        y >>= 1
        if y > 0:
            x = np.float32(x * x)
    if round_idx < 0:
        acc = np.float32(np.float32(1.0) / acc)
    # copied without a stream sync: the copy from pageable memory is
    # staged before the call returns
    return torch.tensor(np.float32(cfg.lr) * acc, dtype=torch.float32
                        ).to(device, non_blocking=True)
