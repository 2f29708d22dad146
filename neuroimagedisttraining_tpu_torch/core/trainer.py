"""The local trainer: client-side SGD and evaluation.

A client's state is two dicts of tensors keyed by the model's parameter and
buffer names (``params``, ``bstats`` for the BatchNorm running stats); the
model runs on them through ``torch.func.functional_call``, so one module
serves every client.

- ``local_train``: E epochs of minibatch SGD on the client's padded data,
  walking per-epoch permutations in ``batch_size`` strides. The last batch
  of an epoch wraps to the epoch's start; the wrapped filler rows weigh 0
  in the loss (the mean is the true partial batch's) but still reach
  BatchNorm, as in the reference. A client runs ``ceil(n / B)`` steps per
  epoch; the reference's further masked no-op steps are skipped. Under
  ``batch_order="replacement"`` each step draws its rows uniformly
  instead. FedProx and Ditto add a proximal pull toward a reference
  model after every step. The optimizer state (SGD's momentum buffers,
  Adam's moments and step count) starts at zero, or carries on from a
  caller's (Sub-FedAvg's epoch-1 and tail calls share one).
- ``eval_grad``: the dense gradient of one batch in evaluation mode
  (DisPFL's gradient probe).
- ``evaluate``: chunked eval returning correct / loss sum / total and the
  scores for AUC (the logit; with several classes the last class's
  log-probability).

The loss is BCE-with-logits for one logit and softmax cross-entropy for
``num_classes > 1``, on the model's primary logits (``primary_logits``).
Under ``precision="bf16_mixed"`` the model computes in bfloat16 and the
loss, the gradients and the state stay float32; a ``loss_scale`` other
than 1 multiplies the loss before the gradient and divides the gradients
(and the returned loss) after it.

Randomness (epoch permutations, replacement batch rows, dropout keep-masks)
comes from an explicit ``torch.Generator`` on the trainer's device;
``perms``, ``batch_idx`` and ``dropout_masks`` can be given instead, so
tests can feed the reference's draws.
"""

from __future__ import annotations

import math

import torch
from torch.func import functional_call

from neuroimagedisttraining_tpu_torch.config import OptimConfig
from neuroimagedisttraining_tpu_torch.core.losses import (
    make_loss, predictions,
)
from neuroimagedisttraining_tpu_torch.core.optim import (
    AdamState, LocalOptimizer, validate_precision,
)
from neuroimagedisttraining_tpu_torch.device import resolve_device
from neuroimagedisttraining_tpu_torch.models import primary_logits

State = dict[str, torch.Tensor]


def epoch_permutations(generator: torch.Generator, epochs: int,
                       max_samples: int, n_valid: int,
                       device: torch.device) -> torch.Tensor:
    """[epochs, max_samples]: per epoch, a uniform permutation of the valid
    rows ``[0, n_valid)`` followed by the padded rows."""
    u = torch.rand((epochs, max_samples), generator=generator, device=device)
    u[:, n_valid:] = 2.0
    return torch.argsort(u, dim=-1)


def prox_pull_(params: list[torch.Tensor], ref: list[torch.Tensor], lr,
               lamda: float) -> None:
    """The proximal pull ``w -= (lr * lamda) * (w - ref)`` in place, in
    the reference's order of operations (three multi-tensor passes)."""
    d = torch._foreach_sub(params, ref)
    torch._foreach_mul_(d, lr * lamda)
    torch._foreach_sub_(params, d)


class LocalTrainer:
    """Trainer bound to one model, optimizer config and device. A CUDA
    device is resolved through ``device.resolve_device`` before the model
    is put on it, so every engine and library caller runs with the fp32
    contract (TF32 off) and cuDNN's deterministic algorithms."""

    def __init__(self, model: torch.nn.Module, optim: OptimConfig,
                 device: torch.device, generator: torch.Generator,
                 dropout_masks: tuple[torch.Tensor, ...] | None = None,
                 num_classes: int = 1):
        validate_precision(optim)
        device = resolve_device(device)
        self.model = model.to(device)
        self.optim_cfg = optim
        self.num_classes = num_classes
        self.loss = make_loss(num_classes)
        self._loss_scale = float(optim.loss_scale)
        self.device = device
        self.generator = generator
        #: fixed dropout keep-masks for every training forward (tests);
        #: None draws fresh ones from ``generator``
        self.dropout_masks = dropout_masks
        self.opt = LocalOptimizer(optim)
        #: the rank of the model's input (batch and channel included)
        self.input_rank = getattr(model, "input_rank", 5)

    @staticmethod
    def _prep(x: torch.Tensor, input_rank: int = 5) -> torch.Tensor:
        """A batch of the data, as the model of ``input_rank`` takes it, in
        float32 (a raw cast): uint8 volumes [B, D, H, W] -> [B, 1, D, H,
        W]; images [B, H, W, C] -> NCHW; single-channel images [B, H, W]
        -> [B, 1, H, W]."""
        x = x.to(torch.float32)
        if input_rank == 4 and x.dim() == 4:
            return x.permute(0, 3, 1, 2).contiguous()
        return x.unsqueeze(1) if x.dim() == input_rank - 1 else x

    def apply(self, params: State, bstats: State, x: torch.Tensor,
              train: bool) -> torch.Tensor:
        """The primary logits of prepared input ``x``; in training mode the
        BatchNorm running stats in ``bstats`` are updated in place."""
        kw = {"train": train}
        if train:
            kw["dropout_masks"] = self.dropout_masks
            kw["generator"] = self.generator
        return primary_logits(
            functional_call(self.model, (params, bstats), (x,), kw))

    def _grads(self, loss: torch.Tensor, leaves: State):
        """``(loss, grads)`` of a float32 loss, through the loss scale
        (nothing runs at scale 1)."""
        s = self._loss_scale
        if s == 1.0:
            grads = torch.autograd.grad(loss, list(leaves.values()))
            return loss.detach(), dict(zip(leaves, grads))
        grads = torch.autograd.grad(loss * s, list(leaves.values()))
        return ((loss * s).detach() / s,
                {k: g / s for k, g in zip(leaves, grads)})

    def loss_and_grad(self, params: State, bstats: State, x, y,
                      weights: torch.Tensor | None = None):
        """One batch in training mode: ``(loss, grads, new_bstats)``; the
        inputs are left unchanged."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        new_b = {k: v.clone() for k, v in bstats.items()}
        logits = self.apply(leaves, new_b, self._prep(x, self.input_rank),
                            train=True)
        loss, grads = self._grads(self.loss(logits, y, weights), leaves)
        return loss, grads, new_b

    def init_momentum(self, params: State):
        """The zero optimizer state for ``params`` by leaf name, to pass to
        :meth:`local_train` calls that share it: SGD's momentum buffers
        (None without momentum), or an :class:`AdamState` of dicts."""
        state = self.opt.init(list(params.values()))
        if isinstance(state, AdamState):
            return AdamState(dict(zip(params, state.mu)),
                             dict(zip(params, state.nu)))
        return None if state is None else dict(zip(params, state))

    def local_train(self, params: State, bstats: State, X: torch.Tensor,
                    y: torch.Tensor, n_valid: int, lr, epochs: int,
                    batch_size: int, max_samples: int,
                    mask: State | None = None,
                    prox_lamda: float | None = None,
                    prox_ref: State | None = None,
                    perms: torch.Tensor | None = None,
                    batch_idx: torch.Tensor | None = None,
                    momentum=None):
        """E epochs of local SGD from ``(params, bstats)`` (left unchanged).
        Returns ``(params, bstats, mean_loss)``; ``mask`` re-applies the
        sparse mask after every step. ``momentum`` (from
        :meth:`init_momentum`) is the optimizer state to carry on from,
        updated in place (Adam's step count included); None starts from
        zero.

        Under ``batch_order="replacement"`` each step draws ``batch_size``
        rows uniformly from ``[0, n_valid)`` with an unweighted loss;
        ``batch_idx`` ``[epochs * ceil(n_valid / B), B]`` gives the rows
        instead (``perms`` is then unused).

        ``prox_lamda`` / ``prox_ref``: after each step (and the mask) the
        proximal pull ``w -= (lr * lamda) * (w - ref)``, in place, so the
        fused step keeps its table of the leaves' addresses."""
        n_valid = int(n_valid)
        my_steps = math.ceil(n_valid / batch_size)
        shuffle = self.optim_cfg.batch_order == "shuffle"
        if shuffle and perms is None:
            perms = epoch_permutations(self.generator, epochs, max_samples,
                                       n_valid, self.device)
        if shuffle:
            perms = perms.to(self.device)
        elif batch_idx is not None:
            batch_idx = batch_idx.to(self.device)
        p = {k: v.detach().clone() for k, v in params.items()}
        b = {k: v.clone() for k, v in bstats.items()}
        names = list(p)
        p_list = [p[k] for k in names]
        m_list = [mask[k] for k in names] if mask is not None else None
        ref_list = ([prox_ref[k] for k in names] if prox_lamda is not None
                    else None)
        if momentum is None:
            trace = self.opt.init(p_list)
        elif isinstance(momentum, AdamState):
            trace = AdamState([momentum.mu[k] for k in names],
                              [momentum.nu[k] for k in names], momentum.count)
        else:
            trace = [momentum[k] for k in names]
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        offsets = torch.arange(batch_size, device=self.device)
        for e in range(epochs):
            for s in range(my_steps):
                if shuffle:
                    pos = s * batch_size + offsets
                    idx = perms[e][pos % max(n_valid, 1)]
                    w = (pos < n_valid).to(torch.float32)
                else:
                    idx = (batch_idx[e * my_steps + s] if batch_idx is not None
                           else torch.randint(0, max(n_valid, 1),
                                              (batch_size,),
                                              generator=self.generator,
                                              device=self.device))
                    w = None
                loss, grads, b = self.loss_and_grad(p, b, X[idx], y[idx], w)
                self.opt.step(p_list, [grads[k] for k in names], trace, lr,
                              m_list)
                if prox_lamda is not None:
                    prox_pull_(p_list, ref_list, lr, prox_lamda)
                loss_sum = loss_sum + loss
        if isinstance(momentum, AdamState):
            momentum.count = trace.count
        return p, b, loss_sum / max(epochs * my_steps, 1)

    def eval_grad(self, params: State, bstats: State, x: torch.Tensor,
                  y: torch.Tensor) -> State:
        """The dense gradient of the mean loss on one batch in evaluation
        mode: no dropout, BatchNorm from its running stats (``bstats`` is
        left unchanged). The stem's weight gradient is a training step's
        (``ops/stemconv.py`` under ``NIDT_FAST_STEM``)."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        logits = self.apply(leaves, bstats, self._prep(x, self.input_rank),
                            train=False)
        return self._grads(self.loss(logits, y), leaves)[1]

    @torch.no_grad()
    def evaluate(self, params: State, bstats: State, X: torch.Tensor,
                 y: torch.Tensor, valid: torch.Tensor, batch_size: int = 32):
        """Chunked eval: ``test_correct``, ``test_loss`` (sum),
        ``test_total`` and the ``scores`` for AUC (the logit; with several
        classes the last class's log-probability). A model that normalises
        by the batch's own statistics in evaluation (its
        ``eval_batch_stats``: the DARTS search net, ``ipbn``) sees its last
        chunk padded with zero rows to ``batch_size``, as the reference
        pads every chunk, so its statistics are the reference's."""
        correct = torch.zeros((), device=self.device)
        loss = torch.zeros((), device=self.device)
        scores = []
        v_all = valid.to(torch.float32)
        pad = getattr(self.model, "eval_batch_stats", False)
        for i in range(0, X.shape[0], batch_size):
            xb, yb, vb = (X[i:i + batch_size], y[i:i + batch_size],
                          v_all[i:i + batch_size])
            rows = xb.shape[0]
            if pad and rows < batch_size:
                xb, yb, vb = (torch.cat([t, t.new_zeros(
                    (batch_size - rows, *t.shape[1:]))]) for t in (xb, yb, vb))
            logits = self.apply(params, bstats,
                                self._prep(xb, self.input_rank), train=False)
            correct = correct + torch.sum(
                (predictions(logits, self.num_classes)
                 == yb.to(torch.int32)) * vb)
            loss = loss + self.loss(logits, yb, vb) * torch.sum(vb)
            scores.append((logits.reshape(xb.shape[0], -1)[:, 0]
                           if self.num_classes == 1
                           else torch.log_softmax(logits, -1)[:, -1])[:rows])
        return {"test_correct": correct, "test_loss": loss,
                "test_total": torch.sum(v_all), "scores": torch.cat(scores)}
