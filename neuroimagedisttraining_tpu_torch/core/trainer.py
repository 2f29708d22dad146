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
  caller's (Sub-FedAvg's epoch-1 and tail calls share one). Every step
  runs on static buffers through its configuration's ``StepGraph``
  (``core/graphs.py``): on a CUDA device a graph captured at the
  configuration's second step and replayed after.
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

import contextlib
import math
import weakref

import torch
from torch.func import functional_call

from neuroimagedisttraining_tpu_torch.config import OptimConfig
from neuroimagedisttraining_tpu_torch.core.losses import (
    make_loss, predictions,
)
from neuroimagedisttraining_tpu_torch.core.optim import (
    AdamState, LocalOptimizer, validate_precision,
)
from neuroimagedisttraining_tpu_torch.core.graphs import (
    StepGraph, graph_stream,
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
        #: each local step runs through its configuration's
        #: :class:`StepGraph` (``core/graphs.py``): captured as a CUDA graph
        #: and replayed on a CUDA device; False runs the same steps on the
        #: same buffers without capture (the eager steps that a graph's
        #: replays are held against)
        self.capture_steps = device.type == "cuda"
        self._graphs: dict[tuple, StepGraph] = {}
        #: on a CUDA device every step graph runs on the device's graph
        #: stream (``core/graphs.py`` ``graph_stream``) and captures into
        #: one pool (made at first use): the graphs of one generator read
        #: its offset from one device tensor that each replay sets first,
        #: so they run one after another anyway, and one stream lets each
        #: capture reuse the blocks that earlier captures and eager steps
        #: freed
        self._graph_stream = None
        self._graph_pool = None
        #: captures and replays of graphs since dropped, and the
        #: configurations captured before (a capture again is a recapture)
        self._dropped_stats = (0, 0)
        self._captured: set = set()
        #: the engine label of the compute profiler's step records
        self.obs_engine = "trainer"
        #: the rank of the model's input (batch and channel included)
        self.input_rank = getattr(model, "input_rank", 5)

    @staticmethod
    def _prep(x: torch.Tensor, input_rank: int = 5) -> torch.Tensor:
        """A batch of the data, as the model of ``input_rank`` takes it, in
        float32 (a raw cast): uint8 volumes [B, D, H, W] -> [B, 1, D, H,
        W]; images [B, H, W, C] -> NCHW; single-channel images [B, H, W]
        -> [B, 1, H, W]."""
        x = x.to(torch.float32)  # nidt: allow[precision-upcast] -- the input's raw cast: uint8 volumes enter as float32, as the reference's step takes them
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
        fused step keeps its table of the leaves' addresses.

        The steps run on the configuration's static buffers (the client's
        state is copied in first and out after the last step; each step's
        batch rows are gathered into them) through its
        :class:`StepGraph`. ``lr`` is taken as a float32 0-d tensor."""
        n_valid = int(n_valid)
        my_steps = math.ceil(n_valid / batch_size)
        shuffle = self.optim_cfg.batch_order == "shuffle"
        # a client of no rows (a mesh's padding client) takes no step and
        # draws nothing, so padding moves no real client's draws
        if shuffle and perms is None and n_valid > 0:
            perms = epoch_permutations(self.generator, epochs, max_samples,
                                       n_valid, self.device)
        if shuffle and perms is not None:
            perms = perms.to(self.device)
        elif batch_idx is not None:
            batch_idx = batch_idx.to(self.device)
        offsets = torch.arange(batch_size, device=self.device)

        def batch(e: int, s: int):
            """Step ``(e, s)``'s row indices and filler weights (None: an
            unweighted loss)."""
            if shuffle:
                pos = s * batch_size + offsets
                return (perms[e][pos % max(n_valid, 1)],
                        (pos < n_valid).to(torch.float32))
            if batch_idx is not None:
                return batch_idx[e * my_steps + s], None
            return torch.randint(0, max(n_valid, 1), (batch_size,),
                                 generator=self.generator,
                                 device=self.device), None

        steps = [(e, s) for e in range(epochs) for s in range(my_steps)]
        if not isinstance(lr, torch.Tensor):
            lr = torch.tensor(lr, dtype=torch.float32, device=self.device)
        kind = ("adam" if self.opt.adam else
                "sgd" if self.optim_cfg.momentum > 0 else "none")
        # an unweighted loss (replacement batches) and a weighted one are
        # different steps, as are a masked, a proximal and a plain one
        cur = (torch.cuda.current_stream(self.device).cuda_stream
               if self.device.type == "cuda" else 0)
        key = (X.dtype, tuple(X.shape[1:]), y.dtype, tuple(y.shape[1:]),
               batch_size, shuffle, mask is not None, prox_lamda, kind, cur,
               self.capture_steps)
        g = self._step_graph(key, params, bstats, X, y, batch_size, shuffle,
                             mask is not None, prox_lamda is not None,
                             prox_lamda, kind)
        st, names = g.static, g.names
        ambient = (torch.cuda.current_stream(self.device)
                   if g.stream is not None else None)
        if g.stream is not None:
            g.stream.wait_stream(ambient)

        def on_stream():
            return (torch.cuda.stream(g.stream) if g.stream is not None
                    else contextlib.nullcontext())

        with on_stream(), torch.no_grad():
            for k in names:
                st["p"][k].copy_(params[k])
                if mask is not None:
                    st["mask"][k].copy_(mask[k])
                if prox_lamda is not None:
                    st["ref"][k].copy_(prox_ref[k])
            for k, v in bstats.items():
                st["b"][k].copy_(v)
            st["lr"].copy_(lr)
            st["loss_sum"].zero_()
            if kind == "adam":
                trace = (AdamState([momentum.mu[k] for k in names],
                                   [momentum.nu[k] for k in names],
                                   momentum.count)
                         if momentum is not None
                         else self.opt.init(g.p_list))
            elif st["trace"] is not None:
                for i, k in enumerate(names):
                    if momentum is None:
                        st["trace"][i].zero_()
                    else:
                        st["trace"][i].copy_(momentum[k])
        for e, s in steps:
            with on_stream():
                idx, w = batch(e, s)
                with torch.no_grad():
                    torch.index_select(X, 0, idx, out=st["x"])
                    torch.index_select(y, 0, idx, out=st["y"])
                    if w is not None:
                        st["w"].copy_(w)
                loss, grads = g()
                if kind == "adam":
                    self.opt.step(g.p_list, grads, trace, st["lr"],
                                  g.m_list)
                    if prox_lamda is not None:
                        prox_pull_(g.p_list, g.ref_list, st["lr"],
                                   prox_lamda)
                    with torch.no_grad():
                        st["loss_sum"].add_(loss)
        if ambient is not None:
            ambient.wait_stream(g.stream)
        with torch.no_grad():
            p = {k: st["p"][k].clone() for k in names}
            b = {k: v.clone() for k, v in st["b"].items()}
            if kind == "sgd" and momentum is not None:
                for i, k in enumerate(names):
                    momentum[k].copy_(st["trace"][i])
            if kind == "adam" and momentum is not None:
                momentum.count = trace.count
            loss = st["loss_sum"] / max(len(steps), 1)
        return p, b, loss

    # ---------- the local step and its CUDA graph ----------

    def _step_graph(self, key, params: State, bstats: State, X, y, bsz: int,
                    weighted: bool, masked: bool, prox: bool,
                    prox_lamda, momentum_kind: str):
        """The :class:`StepGraph` of one step configuration with its static
        buffers, made at first use."""
        g = self._graphs.get(key)
        if g is not None:
            return g
        dev = self.device
        st = {
            "p": {k: torch.empty_like(v) for k, v in params.items()},
            "b": {k: torch.empty_like(v) for k, v in bstats.items()},
            "x": torch.empty((bsz, *X.shape[1:]), dtype=X.dtype, device=dev),
            "y": torch.empty((bsz, *y.shape[1:]), dtype=y.dtype, device=dev),
            "w": (torch.empty(bsz, dtype=torch.float32, device=dev)
                  if weighted else None),
            "lr": torch.empty((), dtype=torch.float32, device=dev),
            "loss_sum": torch.zeros((), dtype=torch.float32, device=dev),
            "mask": ({k: torch.empty_like(v) for k, v in params.items()}
                     if masked else None),
            "ref": ({k: torch.empty_like(v) for k, v in params.items()}
                    if prox else None),
        }
        names = list(st["p"])
        p_list = [st["p"][k] for k in names]
        st["trace"] = ([torch.zeros_like(v) for v in p_list]
                       if momentum_kind == "sgd" else None)
        m_list = ([st["mask"][k] for k in names] if masked else None)
        ref_list = [st["ref"][k] for k in names] if prox else None
        adam = momentum_kind == "adam"
        # the trainer holds its graphs: the step reaches it weakly
        tr = weakref.proxy(self)

        def body():
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in st["p"].items()}
            logits = tr.apply(leaves, st["b"],
                              tr._prep(st["x"], tr.input_rank), train=True)
            loss, grads = tr._grads(tr.loss(logits, st["y"], st["w"]),
                                    leaves)
            grads = [grads[k] for k in names]
            if adam:  # its bias corrections are host floats of the count
                return loss, grads
            tr.opt.step(p_list, grads, st["trace"], st["lr"], m_list)
            if prox:
                prox_pull_(p_list, ref_list, st["lr"], prox_lamda)
            st["loss_sum"].add_(loss)
            return loss, grads

        def notify(phase: str, seconds: float) -> None:
            from neuroimagedisttraining_tpu_torch.obs import compute

            if phase == "compile":
                compute.note_compile(tr.obs_engine, "step",
                                     recompile=key in tr._captured)
                tr._captured.add(key)
            compute.note_dispatch(tr.obs_engine, "step", seconds,
                                  rounds=0, phase=phase)

        if dev.type == "cuda" and self._graph_stream is None:
            self._graph_stream = graph_stream(dev)
        if dev.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        g = StepGraph(body, dev, self.generator, capture=self.capture_steps,
                      notify=notify, stream=self._graph_stream,
                      pool=self._graph_pool)
        g.static, g.names, g.p_list, g.m_list, g.ref_list = (
            st, names, p_list, m_list, ref_list)
        self._graphs[key] = g
        return g

    @property
    def graph_stats(self) -> tuple[int, int]:
        """``(captures, replays)`` over every step configuration, those of
        dropped graphs included."""
        return (self._dropped_stats[0]
                + sum(g.captures for g in self._graphs.values()),
                self._dropped_stats[1]
                + sum(g.replays for g in self._graphs.values()))

    def drop_graphs(self) -> None:
        """Drop every step graph and its static buffers (a rollback, an
        escalated defense, a shrunk mesh): the next ``local_train`` of a
        configuration runs its first step eagerly and captures again. The
        device is synchronized first: no replay is in flight when its graph
        and buffers go. The graphs' pool and the cached blocks then go back
        to the device (a host boundary, already synchronized), so the
        graphs captured next do not stand beside the dropped ones."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._dropped_stats = self.graph_stats
        self._graphs.clear()
        self._graph_pool = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def release_graphs(self) -> None:
        """The end of a run (``FederatedEngine.release``): drop every step
        graph, its static buffers and the pool (:meth:`drop_graphs`), and
        forget which configurations were captured, so that a later run's
        captures are first captures, not recaptures."""
        self.drop_graphs()
        self._captured.clear()

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
