"""Local SGD with the reference's semantics: global-norm clip, then
``g + wd * p``, then momentum ``t = g + m * t``, then ``p += -lr * t``
(lr applied after momentum, as ``torch.optim.SGD`` does), then the sparse
mask ``p *= mask``. The momentum buffers start at zero every round (the
reference builds a fresh optimizer per round).

``fused_update=False`` runs the chain as plain PyTorch operations
(``ops.fused_update.sgd_step_plain``); ``fused_update=True`` runs it as the
fused CUDA step, the global norm and then one pass over every leaf
(``ops.fused_update.fused_sgd_step``, which takes the same plain path for
CPU tensors). Both update in place.
"""

from __future__ import annotations

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.config import OptimConfig
from neuroimagedisttraining_tpu_torch.ops.fused_update import (
    fused_sgd_step, sgd_step_plain,
)


class LocalOptimizer:
    """The SGD chain of one config, over lists of parameter leaves."""

    def __init__(self, cfg: OptimConfig):
        if cfg.client_optimizer != "sgd":
            raise ValueError(f"the port has the sgd client optimizer only, "
                             f"not {cfg.client_optimizer!r}")
        self.cfg = cfg

    def init(self, params: list[torch.Tensor]) -> list[torch.Tensor] | None:
        """Zero momentum buffers (None when momentum is 0)."""
        if self.cfg.momentum <= 0:
            return None
        return [torch.zeros_like(p) for p in params]

    def step(self, params, grads, trace, lr, mask=None) -> None:
        """One in-place step: the fused kernel (the reference's
        ``fused_apply``) under ``fused_update``, else the plain chain."""
        c = self.cfg
        fn = fused_sgd_step if c.fused_update else sgd_step_plain
        fn(params, grads, trace, mask, clip=c.grad_clip, wd=c.wd,
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
