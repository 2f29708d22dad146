"""Local-only baseline: every client trains its own model every round and
nothing is communicated.

Each round every client with rows trains its persistent model for
``epochs`` with a fresh optimizer (clients with no rows take no step); the
round's scalar is the sample-weighted mean of the clients' losses.
Evaluation is of the personal models only. Streamed, each round walks
every client's training rows in chunks (the reference package's
``engines/local.py:138-176``).
"""

from __future__ import annotations

import logging

import torch

from neuroimagedisttraining_tpu_torch.engines.base import FederatedEngine
from neuroimagedisttraining_tpu_torch.engines.program import RoundStages

log = logging.getLogger(__name__)


class LocalEngine(FederatedEngine):
    name = "local"
    trains_sampled = False
    supports_cohort_sharding = True
    cohort_label = "local-only cohort"

    def round_stages(self):
        return RoundStages(gathers_cohort=False)

    def round_sampling(self, round_idx):
        return None

    def run_round(self, round_idx, per_params, per_bstats):
        """Every client's local training. Returns ``(per_params,
        per_bstats, loss)``."""
        lr = self.round_lr(round_idx)
        per_params, per_bstats = list(per_params), list(per_bstats)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)

        def train(c, rows):
            if rows.n == 0:
                return per_params[c], per_bstats[c], zero
            return self.client_train(round_idx, c, rows, per_params[c],
                                     per_bstats[c], lr, self.cfg.optim.epochs)

        out = self.map_clients(train, range(self.num_clients))
        losses = [o[2] for o in out]
        for c, o in enumerate(out):
            per_params[c], per_bstats[c] = o[0], o[1]
        w = self.to_device(self.n_train).to(torch.float32)
        loss = (torch.sum(torch.stack(losses) * w)
                / torch.clamp(torch.sum(w), min=1e-9))
        return per_params, per_bstats, loss

    def window_round(self, carry, round_idx, sampled):
        *carry, loss = self.run_round(round_idx, *carry)
        return tuple(carry), {"loss": loss}

    def train(self, init_state=None) -> dict:
        """The whole run from ``init_state`` (default
        :meth:`init_global_state`) on every client."""
        cfg = self.cfg
        params, bstats = self.start_state(init_state)
        per_params, per_bstats = self.broadcast_states(params, bstats,
                                                       self.num_clients)
        history, round_seconds = [], []

        def on_round(r, carry, row, seconds, sampled):
            round_seconds.append(seconds)
            if self.is_eval_round(r):
                m = self.eval_personalized(*carry)
                self.stat_info["person_test_acc"].append(m["acc"])
                self.metrics(r, train_loss=row["loss"], **m)
                history.append({"round": r, "train_loss": row["loss"], **m})
                log.info("round %d: %s", r, history[-1])

        per_params, per_bstats = self.run_rounds((per_params, per_bstats),
                                                 on_round)
        m = self.eval_personalized(per_params, per_bstats)
        self.metrics(-1, personal=m)
        return {"personal_params": per_params,
                "personal_batch_stats": per_bstats, "history": history,
                "final_personal": m, "round_seconds": round_seconds}
