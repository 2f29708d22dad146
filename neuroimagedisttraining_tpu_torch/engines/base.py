"""The engine pieces SalientGrads needs: client sampling, the sample-weighted
FedAvg with its non-finite-upload guard, personal-state scatter, and
global / personal evaluation.

Clients run one after another in a Python loop (PyTorch's form of the
reference's ``vmap`` over a client axis); their states are dicts of
tensors on the device, and a round syncs with the host only where the
host needs a value (the evaluation metrics).
"""

from __future__ import annotations

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.config import ExperimentConfig
from neuroimagedisttraining_tpu_torch.core.losses import binary_auc
from neuroimagedisttraining_tpu_torch.core.optim import round_lr
from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
from neuroimagedisttraining_tpu_torch.data.federate import FederatedData

State = dict[str, torch.Tensor]


class FederatedEngine:
    """Shared state and helpers of a federated run."""

    def __init__(self, cfg: ExperimentConfig, data: FederatedData,
                 trainer: LocalTrainer):
        self.cfg = cfg
        self.data = data
        self.trainer = trainer
        self.device = trainer.device
        self.num_clients = data.num_clients
        self.real_clients = int(np.sum(data.n_train > 0))

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

    def sanitize_aggregate(self, params_up: list[State],
                           bstats_up: list[State], ref_params: State,
                           ref_bstats: State, ns: torch.Tensor,
                           losses: torch.Tensor):
        """The round's tail: a client whose upload holds a NaN/Inf is
        swapped for the broadcast reference and weighs 0 (without a
        defense, one bad client would poison the mean). Returns
        ``(params, bstats, mean_loss, n_bad)``, all on the device."""
        finite = self.finite_per_client(
            [{**p, **b} for p, b in zip(params_up, bstats_up)])

        def guard(ups, ref):
            return [{k: torch.where(finite[s], v, ref[k])
                     for k, v in up.items()} for s, up in enumerate(ups)]

        w = ns.to(torch.float32) * finite.to(torch.float32)
        new_params = self.aggregate(guard(params_up, ref_params), w)
        new_bstats = self.aggregate(guard(bstats_up, ref_bstats), w)
        safe = torch.where(torch.isfinite(losses), losses,
                           torch.zeros_like(losses))
        mean_loss = torch.sum(safe * w) / torch.clamp(torch.sum(w), min=1e-9)
        return new_params, new_bstats, mean_loss, torch.sum(~finite)

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

    def _eval_clients(self, states: list[tuple[State, State]]
                      ) -> dict[str, float]:
        """Each client's state on its own test rows, summarized."""
        X, y, n = self.data.X_test, self.data.y_test, self.data.n_test
        rows = []
        for c in range(X.shape[0]):
            params, bstats = states[c]
            valid = torch.arange(X.shape[1], device=self.device) < int(n[c])
            m = self.trainer.evaluate(params, bstats, X[c], y[c], valid)
            auc = binary_auc(m["scores"], y[c], valid)
            rows.append(torch.stack([m["test_correct"], m["test_loss"],
                                     m["test_total"], auc]))
        host = torch.stack(rows).cpu().numpy()   # one device read
        return self._summarize(*host.T, n=n)

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
