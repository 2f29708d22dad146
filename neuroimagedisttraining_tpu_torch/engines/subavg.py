"""Sub-FedAvg: per-client iterative magnitude pruning with an accept test,
and an average over the clients that keep each weight.

- Every client holds a personal mask, all ones at the start (over every
  leaf), which only ever loses entries.
- A sampled client trains ``w_global * mask`` under its mask for one
  epoch, takes the candidate mask m1 (``ops/prune.py`` ``fake_prune``),
  trains the remaining epochs with the same momentum buffers, and takes
  m2. With one epoch m1 equals m2 and no prune is ever accepted.
- The prune is accepted where the masks moved (``mask_distance_mean(m1,
  m2) > dist_thresh``), the model entering the round was denser than
  ``dense_ratio`` (``density_all_leaves``) and the m2-pruned model's
  accuracy on the client's training rows passes ``acc_thresh``. Then the
  weights are multiplied by m2 and the mask becomes m2.
- The server's new value of each weight is the mean over the sampled
  clients whose old mask keeps it, and its previous value where none
  does; BatchNorm stats are the plain mean.
- Client ``c``'s personal model is ``w_global * mask_c`` with the global
  BatchNorm stats.

Streamed, a round walks its sampled clients in chunks; the accept test's
accuracy is taken on the same chunk's training rows (the reference
package's ``engines/subavg.py:267-290``).

``perms_for`` is asked for the first epoch with ``track="first"`` and for
the epochs after it with ``track="tail"``. ``stat_info`` counts the dense
model down to every sampled client and the new masks' nonzero entries up,
and the dense training FLOPs of the round's samples and epochs.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.engines.base import FederatedEngine
from neuroimagedisttraining_tpu_torch.engines.program import RoundStages
from neuroimagedisttraining_tpu_torch.ops import flops as flops_ops
from neuroimagedisttraining_tpu_torch.ops.masks import ones_mask
from neuroimagedisttraining_tpu_torch.ops.prune import (
    density_all_leaves, fake_prune, mask_distance_mean,
)

log = logging.getLogger(__name__)


def _times(a: dict, b: dict) -> dict:
    return {k: v * b[k] for k, v in a.items()}


def _f32(x: float) -> torch.Tensor:
    """A threshold as the reference compares it: in float32."""
    return torch.tensor(x, dtype=torch.float32)


class SubFedAvgEngine(FederatedEngine):
    name = "subavg"
    supports_cohort_sharding = True

    def round_stages(self):
        return RoundStages()

    def client_round(self, round_idx: int, c: int, rows, params, bstats,
                     mask, lr):
        """One sampled client on its training ``rows``: train, the two
        candidate masks, the accept test. Returns ``(params, bstats, mask,
        loss, dist, accept)``, the last three as device scalars."""
        o, s = self.cfg.optim, self.cfg.sparsity
        w_per = _times(params, mask)
        dense = density_all_leaves(w_per)
        momentum = self.trainer.init_momentum(w_per)
        p, b, loss = self.client_train(round_idx, c, rows, w_per, bstats, lr,
                                       1, track="first", mask=mask,
                                       momentum=momentum)
        m1 = fake_prune(s.each_prune_ratio, p, mask)
        tail = max(o.epochs - 1, 0)
        if tail:
            p, b, loss2 = self.client_train(round_idx, c, rows, p, b, lr,
                                            tail, track="tail", mask=mask,
                                            momentum=momentum)
            loss = (loss + tail * loss2) / o.epochs
        m2 = fake_prune(s.each_prune_ratio, p, mask)
        dist = mask_distance_mean(m1, m2)
        pruned = _times(p, m2)
        valid = torch.arange(rows.X.shape[0], device=self.device) < rows.n
        m = self.trainer.evaluate(pruned, b, rows.X, rows.y, valid)
        acc = m["test_correct"] / torch.clamp(m["test_total"], min=1.0)
        accept = ((dist > _f32(s.dist_thresh))
                  & (dense > _f32(s.dense_ratio))
                  & (acc > _f32(s.acc_thresh)))
        new_p = {k: torch.where(accept, pruned[k], v) for k, v in p.items()}
        new_m = {k: torch.where(accept, m2[k], v) for k, v in mask.items()}
        return new_p, b, new_m, loss, dist, accept

    @staticmethod
    def aggregate_overlap(params, old_masks, ups_p, ups_b, r, n_real):
        """Per weight, the mean over the real sampled clients (``r`` 1, of
        ``n_real``) whose OLD mask keeps it (``sum / count``), the previous
        value where none does; BatchNorm stats the plain mean over the real
        clients."""
        def weigh(states, k):
            x = torch.stack([st[k] for st in states])
            return x * r.reshape((-1,) + (1,) * (x.dim() - 1))

        new_p = {}
        for k, old in params.items():
            count = weigh(old_masks, k).sum(0)
            summed = weigh(ups_p, k).sum(0)
            new_p[k] = torch.where(count > 0,
                                   summed / torch.clamp(count, min=1.0), old)
        new_b = {k: weigh(ups_b, k).sum(0) / n_real for k in ups_b[0]}
        return new_p, new_b

    def run_round(self, round_idx: int, params, bstats, mask_pers, sampled):
        """The sampled clients' composites, the overlap average and the
        personal-mask scatter. Returns ``(params, bstats, mask_pers,
        outs)``, ``outs`` the device scalars ``[loss, mean_dist, n_accept,
        up_nnz]``."""
        lr = self.round_lr(round_idx)
        ups_p, ups_b, new_m, losses, dists, accepts = map(list, zip(
            *self.map_clients(
                lambda c, rows: self.client_round(round_idx, c, rows, params,
                                                  bstats, mask_pers[c], lr),
                sampled)))
        real = self.n_train[sampled] > 0
        r = self.to_device(real.astype(np.float32))
        n_real = torch.clamp(r.sum(), min=1.0)
        new_params, new_bstats = self.aggregate_overlap(
            params, [mask_pers[c] for c in sampled], ups_p, ups_b, r, n_real)
        up_nnz = torch.stack([sum(torch.count_nonzero(x) for x in m.values())
                              for m in new_m]).to(torch.float64)
        outs = torch.stack([
            torch.sum(torch.stack(losses) * r) / n_real,
            torch.sum(torch.stack(dists) * r) / n_real,
            torch.sum(torch.stack(accepts).to(torch.float32) * r),
        ]).to(torch.float64)
        outs = torch.cat([outs, torch.sum(up_nnz * r.to(torch.float64))[None]])
        mask_pers = self.scatter_sampled_rows(mask_pers, new_m, sampled, real)
        return new_params, new_bstats, mask_pers, outs

    def window_round(self, carry, round_idx, sampled):
        params, bstats, mask_pers, outs = self.run_round(round_idx, *carry,
                                                         sampled)
        return (params, bstats, mask_pers), {
            "loss": outs[0], "mean_dist": outs[1], "n_accept": outs[2],
            "up_nnz": outs[3], "nnz": self.masks_nnz(mask_pers)}

    def eval_masked_global(self, params, bstats, mask_pers) -> dict:
        """Client ``c`` evaluates ``w_global * mask_c`` with the global
        BatchNorm stats on its test rows."""
        return self._eval_clients([(_times(params, m), bstats)
                                   for m in mask_pers])

    def train(self, init_state=None) -> dict:
        """The whole run from ``init_state`` (default
        :meth:`init_global_state`)."""
        cfg = self.cfg
        params, bstats = self.start_state(init_state)
        mask_pers = [ones_mask(params) for _ in range(self.num_clients)]
        flops_per_sample = flops_ops.count_training_flops_per_sample(
            self.trainer.model, self.sample_shape)
        n_params = sum(v.numel() for v in params.values())
        history, round_seconds = [], []

        def on_round(r, carry, row, seconds, sampled):
            round_seconds.append(seconds)
            loss, mean_dist, n_accept = (row["loss"], row["mean_dist"],
                                         row["n_accept"])
            n_samples = float(np.sum(self.n_train[sampled]))
            self.stat_info["sum_training_flops"] += (
                flops_per_sample * cfg.optim.epochs * n_samples)
            self.stat_info["sum_comm_params"] += (n_params * len(sampled)
                                                  + row["up_nnz"])
            self.warn_collapsed(row["nnz"], r)
            if self.is_eval_round(r):
                mp = self.eval_masked_global(*carry)
                self.stat_info["person_test_acc"].append(mp["acc"])
                self.metrics(r, train_loss=loss, personal=mp,
                             mean_mask_dist=mean_dist,
                             prunes_accepted=int(n_accept))
                history.append({"round": r, "train_loss": loss,
                                "personal_acc": mp["acc"],
                                "mean_mask_dist": mean_dist,
                                "prunes_accepted": int(n_accept)})
                log.info("round %d: %s", r, history[-1])

        params, bstats, mask_pers = self.run_rounds(
            (params, bstats, mask_pers), on_round)
        m_person = self.eval_masked_global(params, bstats, mask_pers)
        self.metrics(-1, personal=m_person)
        densities = torch.stack([density_all_leaves(_times(params, m))
                                 for m in mask_pers[:self.real_clients]])
        return {"params": params, "batch_stats": bstats,
                "mask_pers": mask_pers, "history": history,
                "final_personal": m_person,
                "client_densities": densities.cpu().tolist(),
                "round_seconds": round_seconds}
