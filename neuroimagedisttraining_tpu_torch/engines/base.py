"""The pieces every engine shares: client sampling, local training of one
client, the sample-weighted FedAvg with its non-finite-upload guard,
personal-state lists and their scatter, global / personal evaluation, the
reference's ``stat_info`` accumulators and the experiment log.

Clients run one after another in a Python loop (PyTorch's form of the
reference's ``vmap`` over a client axis); their states are dicts of
tensors on the device, and a round syncs with the host only where the
host needs a value (the round's loss and evaluation metrics).

An engine reads its clients' rows from the resident federation
(``data/federate.py``) or from a streamed one (``data/stream.py``), the
reference package's ``engines/base.py:104-147``. Every read goes through
:meth:`FederatedEngine.client_rows`, a walk over a list of clients: on the
resident path it slices the stacks; on the streamed path it serves each
client from the current chunk of ``_eval_chunk_size()`` clients while the
next chunk is on its way. A client's result does not depend on the chunk
it came in, so a streamed run equals the resident one. :meth:`plan_walks`
tells the feed the walks a round makes (training, then the evaluations,
then the next round's training), so the last chunk of each walk
prefetches the first of the next. The port has no mesh: the reference's
``stream_sampling`` pads nothing here.

``perms_for(round_idx, client, n_valid[, track])`` may supply a client's
epoch permutations (the tests feed the reference's draws; ``track`` is
``"personal"`` for Ditto's personal track, ``"first"`` and ``"tail"`` for
Sub-FedAvg's first epoch and the epochs after it, and absent otherwise);
by default they come from the trainer's generator.
"""

from __future__ import annotations

import logging
from typing import Iterator, NamedTuple

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.config import ExperimentConfig
from neuroimagedisttraining_tpu_torch.core.losses import binary_auc
from neuroimagedisttraining_tpu_torch.core.optim import round_lr
from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
from neuroimagedisttraining_tpu_torch.data.federate import FederatedData
from neuroimagedisttraining_tpu_torch.ops.masks import mask_nnz
from neuroimagedisttraining_tpu_torch.utils.logging import ExperimentLogger

State = dict[str, torch.Tensor]

log = logging.getLogger(__name__)


class ClientRows(NamedTuple):
    """One client's rows of a split: ``X[Nmax, ...]`` (uint8 volumes or
    float32 images), ``y[Nmax]`` int32 (zero past ``n``) and the true count
    ``n``."""

    X: torch.Tensor
    y: torch.Tensor
    n: int


class FederatedEngine:
    """Shared state and helpers of a federated run."""

    #: the round's training walk covers the sampled clients (else every
    #: client)
    trains_sampled = True
    #: the test walks an evaluation round makes, and the walks after the
    #: last round (``"train"`` a fine-tune of every client)
    eval_walks = 1
    final_walks: tuple[str, ...] = ("test",)

    def __init__(self, cfg: ExperimentConfig, data: FederatedData | None,
                 trainer: LocalTrainer, perms_for=None, stream=None):
        """``data``: the resident federation, or None with ``stream``, a
        ``StreamingFederation``."""
        if (data is None) == (stream is None):
            raise ValueError("an engine takes its data or a stream (one "
                             "of the two)")
        self.cfg = cfg
        self.data = data
        self.stream = stream
        self.trainer = trainer
        self.device = trainer.device
        src = data if data is not None else stream
        self.num_clients = int(src.num_clients)
        #: the clients' training row counts, on the host
        self.n_train = np.asarray(src.n_train, np.int64)
        self.real_clients = int(np.sum(self.n_train > 0))
        self.max_samples = (int(data.X_train.shape[1]) if data is not None
                            else int(stream.nmax_train))
        #: one sample's shape: a volume's (D, H, W), an image's (H, W, C)
        self.sample_shape = (tuple(data.X_train.shape[2:]) if data is not None
                             else tuple(stream.sample_shape))
        self._walks: list[tuple[str, tuple]] = []
        self.perms_for = perms_for
        self.log = (ExperimentLogger(cfg.log_dir, cfg.data.dataset,
                                     cfg.identity())
                    if cfg.log_dir else None)
        # the reference's accounting (its stat_info): communicated
        # parameters and training FLOPs summed over rounds, non-finite
        # uploads dropped, and the accuracy at every evaluation
        self.stat_info: dict = {
            "sum_comm_params": 0.0, "sum_training_flops": 0.0,
            "nonfinite_uploads": 0.0,
            "global_test_acc": [], "person_test_acc": [],
        }

    # ---------- state ----------

    def init_global_state(self) -> tuple[State, State]:
        """Initial ``(params, bstats)`` from a CPU generator seeded with
        ``cfg.seed`` (the same values on every device)."""
        model = self.trainer.model
        gen = torch.Generator().manual_seed(self.cfg.seed)
        model.to("cpu")
        model.reset_parameters(gen)
        model.to(self.device)
        params = {k: v.detach().clone() for k, v in model.named_parameters()}
        bstats = {k: v.clone() for k, v in model.named_buffers()}
        return params, bstats

    def start_state(self, init_state=None) -> tuple[State, State]:
        """The run's initial ``(params, bstats)`` on the device: the given
        ``init_state``, or :meth:`init_global_state`."""
        if init_state is None:
            return self.init_global_state()
        return tuple({k: v.to(self.device) for k, v in st.items()}
                     for st in init_state)

    @staticmethod
    def broadcast_states(params: State, bstats: State, n: int
                         ) -> tuple[list[State], list[State]]:
        """``n`` per-client copies of one state: the personal models. Each
        client owns its tensors (none is shared between clients)."""
        return ([{k: v.clone() for k, v in params.items()} for _ in range(n)],
                [{k: v.clone() for k, v in bstats.items()} for _ in range(n)])

    # ---------- sampling ----------

    def client_sampling(self, round_idx: int) -> np.ndarray:
        """All real clients, or ``np.random.seed(round_idx)`` then a choice
        without replacement: the reference's sampling, whose global-stream
        reseed keeps the cohorts identical to the reference run."""
        total = self.real_clients
        per_round = min(self.cfg.fed.client_num_per_round, total)
        if total == per_round:
            return np.arange(total)
        np.random.seed(round_idx)
        return np.sort(np.random.choice(range(total), per_round,
                                        replace=False))

    def round_lr(self, round_idx: int) -> torch.Tensor:
        return round_lr(self.cfg.optim, round_idx, self.device)

    # ---------- client rows ----------

    def _eval_chunk_size(self) -> int:
        """Clients a streamed chunk holds: ``stream_chunk_clients``, or 4."""
        return self.cfg.stream_chunk_clients or 4

    def _resident(self, split: str):
        d = self.data
        return {"train": (d.X_train, d.y_train, d.n_train),
                "test": (d.X_test, d.y_test, d.n_test),
                "val": (d.X_val, d.y_val, d.n_val)}[split]

    def client_rows(self, ids, split: str = "train"
                    ) -> Iterator[tuple[int, ClientRows]]:
        """Each client of ``ids``, in order, with its rows of ``split``:
        slices of the resident stacks, or the client's rows in the current
        streamed chunk (valid until the walk moves on to the next chunk)."""
        if self.stream is None:
            X, y, n = self._resident(split)
            for c in ids:
                c = int(c)
                yield c, ClientRows(X[c], y[c], int(n[c]))
            return
        walk = (split, tuple(int(c) for c in ids))
        if self._walks and self._walks[0] == walk:
            self._walks.pop(0)
        else:
            self._walks = []
        then = ((np.asarray(self._walks[0][1]), self._walks[0][0])
                if self._walks else None)
        n = getattr(self.stream, f"n_{split}")
        for ch in self.stream.eval_chunks(self._eval_chunk_size(), split,
                                          ids=walk[1], then=then):
            for j, c in enumerate(ch.ids):
                yield int(c), ClientRows(ch.X[j], ch.y[j], int(n[c]))

    def plan_walks(self, round_idx: int, before=()) -> None:
        """Streamed runs: the walks from round ``round_idx`` on that the
        feed may prefetch for (``before`` first): the round's training
        walk, its evaluations, then the next round's training walk, or
        after the last round the ``final_walks``. A walk the plan did not
        foresee is read without a prefetch, and as right."""
        if self.stream is None:
            return
        everyone = tuple(range(self.num_clients))

        def train_walk(r):
            ids = self.client_sampling(r) if self.trains_sampled else everyone
            return ("train", tuple(int(c) for c in ids))

        walks = [*before, train_walk(round_idx)]
        if self.is_eval_round(round_idx):
            walks += [("test", self.eval_ids())] * self.eval_walks
        if round_idx + 1 < self.cfg.fed.comm_round:
            walks.append(train_walk(round_idx + 1))
        else:
            walks += [(split, self.eval_ids() if split == "test"
                       else everyone) for split in self.final_walks]
        self._walks = walks

    # ---------- local training ----------

    def client_train(self, round_idx: int, c: int, rows: ClientRows,
                     params: State, bstats: State, lr, epochs: int,
                     track: str = "global", **kw):
        """Local SGD of client ``c`` from ``(params, bstats)`` on its
        training ``rows``: ``(params, bstats, mean_loss)``. ``track`` names
        the run to ``perms_for``; ``kw`` goes to ``local_train``
        (``mask``, ``prox_lamda``, ``prox_ref``, ``momentum``)."""
        n = rows.n
        perms = None
        if self.perms_for is not None:
            perms = (self.perms_for(round_idx, c, n) if track == "global"
                     else self.perms_for(round_idx, c, n, track))
        return self.trainer.local_train(
            params, bstats, rows.X, rows.y, n, lr, epochs,
            self.cfg.optim.batch_size, self.max_samples, perms=perms, **kw)

    def train_sampled(self, round_idx: int, params: State, bstats: State,
                      sampled, lr, **kw):
        """The sampled clients train from the global model for ``epochs``.
        Returns their ``(params, bstats)`` lists and their losses
        ``[S]``."""
        ups_p, ups_b, losses = [], [], []
        for c, rows in self.client_rows(sampled):
            p, b, loss = self.client_train(round_idx, c, rows, params,
                                           bstats, lr, self.cfg.optim.epochs,
                                           **kw)
            ups_p.append(p)
            ups_b.append(b)
            losses.append(loss)
        return ups_p, ups_b, torch.stack(losses)

    def train_and_aggregate(self, round_idx: int, params: State,
                            bstats: State, sampled, lr, **kw):
        """The sampled clients train from the global model for ``epochs``;
        FedAvg of their uploads. Returns ``(params, bstats, loss, n_bad,
        uploads)``, ``uploads`` the clients' ``(params, bstats)`` lists."""
        ups_p, ups_b, losses = self.train_sampled(round_idx, params, bstats,
                                                  sampled, lr, **kw)
        ns = self.to_device(self.n_train[sampled])
        new_p, new_b, loss, n_bad = self.sanitize_aggregate(
            ups_p, ups_b, params, bstats, ns, losses)
        return new_p, new_b, loss, n_bad, (ups_p, ups_b)

    # ---------- host boundaries ----------

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device, copied without a stream sync (the
        copy from pageable memory is staged before the call returns)."""
        return torch.from_numpy(np.asarray(a)).to(self.device,
                                                  non_blocking=True)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def read_round(self, round_idx: int, loss: torch.Tensor,
                   n_bad: torch.Tensor | None = None) -> float:
        """The round's loss on the host (one device read); non-finite
        uploads go into ``stat_info`` with a warning."""
        if n_bad is None:
            return float(loss)
        loss_h, bad_h = torch.stack([loss, n_bad.to(loss.dtype)]).tolist()
        if bad_h:
            self.stat_info["nonfinite_uploads"] += bad_h
            log.warning("round %d: %d non-finite uploads dropped", round_idx,
                        int(bad_h))
        return loss_h

    def warn_if_masks_collapsed(self, masks: list[State], round_idx: int
                                ) -> np.ndarray:
        """Each real client's count of kept entries over the maskable
        leaves (one device read); logs a warning naming every client whose
        mask kept none (a NaN in the weights or gradients ranks every entry
        out)."""
        nnz = torch.stack([mask_nnz(m) for m in masks[:self.real_clients]]
                          ).cpu().numpy()
        if (nnz == 0).any():
            log.warning("round %d: clients %s have an empty mask (0 kept "
                        "weights); check their local losses for divergence",
                        round_idx, np.flatnonzero(nnz == 0).tolist())
        return nnz

    def metrics(self, round_idx: int, **values) -> None:
        """One metrics record in the experiment log, where there is one."""
        if self.log is not None:
            self.log.metrics(round_idx, **values)

    def is_eval_round(self, round_idx: int) -> bool:
        f = self.cfg.fed
        return (round_idx % f.frequency_of_the_test == 0
                or round_idx == f.comm_round - 1)

    # ---------- aggregation ----------

    @staticmethod
    def finite_per_client(states: list[State]) -> torch.Tensor:
        """[S] bool: client s is finite in every leaf."""
        return torch.stack([
            torch.stack([torch.isfinite(v).all() for v in st.values()]).all()
            for st in states])

    @staticmethod
    def aggregate(states: list[State], weights: torch.Tensor) -> State:
        """Weighted mean over clients: weights normalized first, then
        ``sum_s x_s * w_s`` per leaf (FedAvg)."""
        w = weights / torch.clamp(torch.sum(weights), min=1e-12)
        out = {}
        for k in states[0]:
            x = torch.stack([st[k] for st in states])
            out[k] = torch.sum(x * w.reshape((-1,) + (1,) * (x.dim() - 1)),
                               dim=0)
        return out

    def guard_uploads(self, params_up: list[State], bstats_up: list[State],
                      ref_params: State, ref_bstats: State, ns: torch.Tensor,
                      losses: torch.Tensor):
        """A client whose upload holds a NaN/Inf is swapped for the
        broadcast reference and weighs 0 (without a defense, one bad client
        would poison the mean). Returns ``(params_up, bstats_up, w,
        mean_loss, n_bad)``: the guarded uploads, the weights ``ns`` with
        the bad clients' zeroed, the weighted mean of the finite losses and
        the count of bad clients, all on the device."""
        finite = self.finite_per_client(
            [{**p, **b} for p, b in zip(params_up, bstats_up)])

        def guard(ups, ref):
            return [{k: torch.where(finite[s], v, ref[k])
                     for k, v in up.items()} for s, up in enumerate(ups)]

        w = ns.to(torch.float32) * finite.to(torch.float32)
        safe = torch.where(torch.isfinite(losses), losses,
                           torch.zeros_like(losses))
        mean_loss = torch.sum(safe * w) / torch.clamp(torch.sum(w), min=1e-9)
        return (guard(params_up, ref_params), guard(bstats_up, ref_bstats),
                w, mean_loss, torch.sum(~finite))

    def sanitize_aggregate(self, params_up: list[State],
                           bstats_up: list[State], ref_params: State,
                           ref_bstats: State, ns: torch.Tensor,
                           losses: torch.Tensor):
        """The round's tail: the uploads guarded (:meth:`guard_uploads`),
        then their FedAvg. Returns ``(params, bstats, mean_loss, n_bad)``,
        all on the device."""
        params_up, bstats_up, w, mean_loss, n_bad = self.guard_uploads(
            params_up, bstats_up, ref_params, ref_bstats, ns, losses)
        return (self.aggregate(params_up, w), self.aggregate(bstats_up, w),
                mean_loss, n_bad)

    @staticmethod
    def scatter_sampled_rows(all_states: list, new_states: list,
                             sampled_idx, real) -> list:
        """Write the sampled clients' new states into the per-client list;
        entries whose ``real`` flag is False are dropped."""
        out = list(all_states)
        for c, st, r in zip(sampled_idx, new_states, real):
            if r:
                out[int(c)] = st
        return out

    # ---------- evaluation ----------

    def eval_ids(self) -> tuple[int, ...]:
        """The clients an evaluation takes: every client, or client 0 alone
        under ``fed.ci`` (the reference's CI mode)."""
        return (0,) if self.cfg.fed.ci else tuple(range(self.num_clients))

    def _eval_clients(self, states: list[tuple[State, State]]
                      ) -> dict[str, float]:
        """Each evaluated client's state (:meth:`eval_ids`) on its own test
        rows, summarized (the reference package's ``eval_global_stream``
        and ``eval_personalized_stream`` too: the walk serves both
        paths)."""
        out, n = [], []
        for c, rows in self.client_rows(self.eval_ids(), "test"):
            params, bstats = states[c]
            valid = torch.arange(rows.X.shape[0],
                                 device=self.device) < rows.n
            m = self.trainer.evaluate(params, bstats, rows.X, rows.y, valid)
            auc = binary_auc(m["scores"], rows.y, valid)
            out.append(torch.stack([m["test_correct"], m["test_loss"],
                                    m["test_total"], auc]))
            n.append(rows.n)
        host = torch.stack(out).cpu().numpy()   # one device read
        return self._summarize(*host.T, n=np.asarray(n))

    @staticmethod
    def _summarize(correct, loss, total, auc, n) -> dict[str, float]:
        """Mean over clients with data of the per-client ratios, plus the
        pooled accuracy."""
        correct, loss, total, auc, n = map(np.asarray,
                                           (correct, loss, total, auc, n))
        mask = n > 0
        if not np.any(mask):
            return {"acc": 0.0, "loss": 0.0, "auc": 0.0, "acc_pooled": 0.0}
        accs = correct[mask] / np.maximum(total[mask], 1)
        losses = loss[mask] / np.maximum(total[mask], 1)
        return {
            "acc": float(np.mean(accs)),
            "loss": float(np.mean(losses)),
            "auc": float(np.mean(auc[mask])),
            "acc_pooled": float(correct[mask].sum()
                                / max(total[mask].sum(), 1)),
        }

    def eval_global(self, params: State, bstats: State) -> dict[str, float]:
        return self._eval_clients([(params, bstats)] * self.num_clients)

    def eval_personalized(self, per_params: list[State],
                          per_bstats: list[State]) -> dict[str, float]:
        return self._eval_clients(list(zip(per_params, per_bstats)))
