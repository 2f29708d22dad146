"""Ditto: personalized federated learning with a proximal personal track.

Each round has two tracks over the sampled clients:

- global: each client trains the round's global model for ``epochs``;
  sample-weighted FedAvg of the uploads (non-finite ones dropped) through
  the round's tail (the attack and the defense; no wire codec);
- personal: each client trains its own persistent model for
  ``local_epochs`` with a fresh optimizer, pulled toward the round's
  incoming global model after every step,
  ``w -= (lr * lamda) * (w - w_global)``; the results replace the clients'
  personal models (clients with no rows keep theirs).

Each sampled client runs its global track and then its personal track
on the same rows, so a streamed round reads each client's chunk once.
Evaluation covers the personal and the global models. ``perms_for`` is
asked for the personal track's permutations with ``track="personal"``.
"""

from __future__ import annotations

import logging
import time

import torch

from neuroimagedisttraining_tpu_torch.core import robust
from neuroimagedisttraining_tpu_torch.engines.base import FederatedEngine

log = logging.getLogger(__name__)


class DittoEngine(FederatedEngine):
    name = "ditto"
    eval_walks = 2
    supports_byz_faults = True
    supports_secure_quant = True
    supported_defenses = robust.DEFENSES

    def run_round(self, round_idx, params, bstats, per_params, per_bstats,
                  sampled):
        """Both tracks. Returns ``(params, bstats, per_params, per_bstats,
        loss, n_bad)``; ``loss`` is the global track's."""
        f = self.cfg.fed
        lr = self.round_lr(round_idx)
        ups_p, ups_b, losses, pp, pb = [], [], [], [], []
        for c, rows in self.client_rows(sampled):
            p, b, loss = self.client_train(round_idx, c, rows, params,
                                           bstats, lr, self.cfg.optim.epochs)
            ups_p.append(p)
            ups_b.append(b)
            losses.append(loss)
            p, b, _ = self.client_train(
                round_idx, c, rows, per_params[c], per_bstats[c], lr,
                f.local_epochs, track="personal", prox_lamda=float(f.lamda),
                prox_ref=params)
            pp.append(p)
            pb.append(b)
        new_p, new_b, loss, n_bad = self.defended_aggregate(
            round_idx, sampled, ups_p, ups_b, params, bstats,
            self.to_device(self.n_train[sampled]), torch.stack(losses))
        real = self.n_train[sampled] > 0
        per_params = self.scatter_sampled_rows(per_params, pp, sampled, real)
        per_bstats = self.scatter_sampled_rows(per_bstats, pb, sampled, real)
        return new_p, new_b, per_params, per_bstats, loss, n_bad

    def train(self, init_state=None) -> dict:
        """The whole run from ``init_state`` (default
        :meth:`init_global_state`)."""
        cfg = self.cfg
        params, bstats = self.start_state(init_state)
        per_params, per_bstats = self.broadcast_states(params, bstats,
                                                       self.num_clients)
        history, round_seconds = [], []
        for r in range(cfg.fed.comm_round):
            self.plan_walks(r)
            sampled = self.client_sampling(r)
            log.info("round %d: clients %s", r, sampled.tolist())
            t0 = time.perf_counter()
            params, bstats, per_params, per_bstats, loss, n_bad = \
                self.run_round(r, params, bstats, per_params, per_bstats,
                               sampled)
            loss_h = self.read_round(r, loss, n_bad)
            self._sync()
            round_seconds.append(time.perf_counter() - t0)
            if self.is_eval_round(r):
                m = self.eval_personalized(per_params, per_bstats)
                mg = self.eval_global(params, bstats)
                self.stat_info["person_test_acc"].append(m["acc"])
                self.metrics(r, train_loss=loss_h, personal=m, global_=mg)
                history.append({"round": r, "train_loss": loss_h,
                                "personal_acc": m["acc"],
                                "global_acc": mg["acc"]})
                log.info("round %d: %s", r, history[-1])
        m = self.eval_personalized(per_params, per_bstats)
        return {"params": params, "batch_stats": bstats,
                "personal_params": per_params,
                "personal_batch_stats": per_bstats, "history": history,
                "final_personal": m, "round_seconds": round_seconds}
