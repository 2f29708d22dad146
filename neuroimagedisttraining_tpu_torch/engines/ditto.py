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

import torch

from neuroimagedisttraining_tpu_torch.core import robust
from neuroimagedisttraining_tpu_torch.engines.base import FederatedEngine
from neuroimagedisttraining_tpu_torch.engines.program import RoundStages

log = logging.getLogger(__name__)


class DittoEngine(FederatedEngine):
    name = "ditto"
    eval_walks = 2
    supports_byz_faults = True
    supports_secure_quant = True
    supported_defenses = robust.DEFENSES
    supports_cohort_sharding = True

    def round_stages(self):
        return RoundStages()

    def run_round(self, round_idx, params, bstats, per_params, per_bstats,
                  sampled):
        """Both tracks. Returns ``(params, bstats, per_params, per_bstats,
        loss, n_bad)``; ``loss`` is the global track's."""
        f = self.cfg.fed
        lr = self.round_lr(round_idx)

        def both_tracks(c, rows):
            p, b, loss = self.client_train(round_idx, c, rows, params,
                                           bstats, lr, self.cfg.optim.epochs)
            pp, pb, _ = self.client_train(
                round_idx, c, rows, per_params[c], per_bstats[c], lr,
                f.local_epochs, track="personal", prox_lamda=float(f.lamda),
                prox_ref=params)
            return p, b, loss, pp, pb

        ups_p, ups_b, losses, pp, pb = map(
            list, zip(*self.map_clients(both_tracks, sampled)))
        new_p, new_b, loss, n_bad = self.defended_aggregate(
            round_idx, sampled, ups_p, ups_b, params, bstats,
            self.to_device(self.n_train[sampled]), torch.stack(losses))
        real = self.n_train[sampled] > 0
        per_params = self.scatter_sampled_rows(per_params, pp, sampled, real)
        per_bstats = self.scatter_sampled_rows(per_bstats, pb, sampled, real)
        return new_p, new_b, per_params, per_bstats, loss, n_bad

    def window_round(self, carry, round_idx, sampled):
        *carry, loss, n_bad = self.run_round(round_idx, *carry, sampled)
        return tuple(carry), {"loss": loss, "n_bad": n_bad}

    def train(self, init_state=None) -> dict:
        """The whole run from ``init_state`` (default
        :meth:`init_global_state`)."""
        cfg = self.cfg
        params, bstats = self.start_state(init_state)
        per_params, per_bstats = self.broadcast_states(params, bstats,
                                                       self.num_clients)
        history, round_seconds = [], []

        def on_round(r, carry, row, seconds, sampled):
            round_seconds.append(seconds)
            if self.is_eval_round(r):
                m = self.eval_personalized(*carry[2:])
                mg = self.eval_global(*carry[:2])
                self.stat_info["person_test_acc"].append(m["acc"])
                self.metrics(r, train_loss=row["loss"], personal=m,
                             global_=mg)
                history.append({"round": r, "train_loss": row["loss"],
                                "personal_acc": m["acc"],
                                "global_acc": mg["acc"]})
                log.info("round %d: %s", r, history[-1])

        params, bstats, per_params, per_bstats = self.run_rounds(
            (params, bstats, per_params, per_bstats), on_round)
        m = self.eval_personalized(per_params, per_bstats)
        return {"params": params, "batch_stats": bstats,
                "personal_params": per_params,
                "personal_batch_stats": per_bstats, "history": history,
                "final_personal": m, "round_seconds": round_seconds}
