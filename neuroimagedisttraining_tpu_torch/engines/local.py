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
import time

import torch

from neuroimagedisttraining_tpu_torch.engines.base import FederatedEngine

log = logging.getLogger(__name__)


class LocalEngine(FederatedEngine):
    name = "local"
    trains_sampled = False

    def run_round(self, round_idx, per_params, per_bstats):
        """Every client's local training. Returns ``(per_params,
        per_bstats, loss)``."""
        lr = self.round_lr(round_idx)
        per_params, per_bstats = list(per_params), list(per_bstats)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        losses = []
        for c, rows in self.client_rows(range(self.num_clients)):
            if rows.n == 0:
                losses.append(zero)
                continue
            per_params[c], per_bstats[c], loss = self.client_train(
                round_idx, c, rows, per_params[c], per_bstats[c], lr,
                self.cfg.optim.epochs)
            losses.append(loss)
        w = self.to_device(self.n_train).to(torch.float32)
        loss = (torch.sum(torch.stack(losses) * w)
                / torch.clamp(torch.sum(w), min=1e-9))
        return per_params, per_bstats, loss

    def train(self, init_state=None) -> dict:
        """The whole run from ``init_state`` (default
        :meth:`init_global_state`) on every client."""
        cfg = self.cfg
        params, bstats = self.start_state(init_state)
        per_params, per_bstats = self.broadcast_states(params, bstats,
                                                       self.num_clients)
        history, round_seconds = [], []
        for r in range(cfg.fed.comm_round):
            self.plan_walks(r)
            t0 = time.perf_counter()
            per_params, per_bstats, loss = self.run_round(r, per_params,
                                                          per_bstats)
            loss_h = self.read_round(r, loss)
            self._sync()
            round_seconds.append(time.perf_counter() - t0)
            if self.is_eval_round(r):
                m = self.eval_personalized(per_params, per_bstats)
                self.stat_info["person_test_acc"].append(m["acc"])
                self.metrics(r, train_loss=loss_h, **m)
                history.append({"round": r, "train_loss": loss_h, **m})
                log.info("round %d: %s", r, history[-1])
        m = self.eval_personalized(per_params, per_bstats)
        self.metrics(-1, personal=m)
        return {"personal_params": per_params,
                "personal_batch_stats": per_bstats, "history": history,
                "final_personal": m, "round_seconds": round_seconds}
