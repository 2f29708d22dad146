"""SalientGrads: one global SNIP mask, then masked sample-weighted FedAvg.

- Phase 1 (once): every client with data scores ``|w * grad|`` by IterSNIP
  on its own rows; the server takes the mean over those clients and keeps
  the global top ``dense_ratio`` of the maskable weights
  (``ops/snip.py``; the threshold comes from the count-greater-or-equal
  kernel of ``ops/topk.py``). ``snip_mask=False`` keeps every weight.
- Phase 2 (rounds): the sampled clients train from the global model with
  the mask re-applied after every step; FedAvg weighs them by sample count
  through the round's tail (the attack, the wire codec against the phase-1
  mask, which both ends hold: no bitmap and no top-k select; the defense);
  each client's personal model is its latest honest local result; the global and
  personal models are evaluated on the clients' test rows.

``perms_for`` (engines/base.py) and ``snip_idx_for(client, n_valid)`` may
supply the epoch permutations and the IterSNIP batch rows (the tests feed
the reference's draws); by default both come from the trainer's generator.

Streamed (``stream``): phase 1 walks every client's training rows in
chunks, keeping only the score sum on the device; phase 2 walks each
round's sampled clients, the next round's first chunk prefetched behind
the round's evaluations (the reference package's
``engines/salientgrads.py:136-158,383-420``).

``stat_info`` holds the reference's accounting: the training FLOPs per
sample under the mask's densities times the round's samples and epochs,
and the mask's nonzero count per sampled client as communicated
parameters.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.core import robust
from neuroimagedisttraining_tpu_torch.engines.base import FederatedEngine
from neuroimagedisttraining_tpu_torch.engines import program as round_program
from neuroimagedisttraining_tpu_torch.engines.program import RoundStages
from neuroimagedisttraining_tpu_torch.ops import flops as flops_ops
from neuroimagedisttraining_tpu_torch.ops.masks import mask_density, ones_mask
from neuroimagedisttraining_tpu_torch.ops.snip import (
    iter_snip_scores, mask_from_scores,
)


class SalientGradsEngine(FederatedEngine):
    name = "salientgrads"
    eval_walks = 2
    final_walks = ("test", "test")
    supports_byz_faults = True
    supports_wire_codec = True
    supports_secure_quant = True
    supported_defenses = robust.DEFENSES
    supports_cohort_sharding = True
    ckpt_slots = ("params", "batch_stats", "per_params", "per_bstats")
    #: the phase-1 mask once made (the codec's mask handoff)
    _masks = None

    def ckpt_extra(self):
        return {"masks": self._masks}

    def restore_extra(self, state):
        self._masks = state["masks"]

    def round_stages(self):
        return RoundStages()

    def __init__(self, cfg, data, trainer, perms_for=None, stream=None,
                 mesh=None, snip_idx_for=None):
        super().__init__(cfg, data, trainer, perms_for, stream=stream,
                         mesh=mesh)
        self.snip_idx_for = snip_idx_for

    # ---------- phase 1: the global mask ----------

    def generate_global_mask(self, params, bstats):
        """``(masks, threshold)`` from the mean IterSNIP scores."""
        s = self.cfg.sparsity
        masks, thr = mask_from_scores(self.mean_scores(params, bstats),
                                      keep_ratio=s.dense_ratio)
        if not s.snip_mask:
            masks = ones_mask(params)
        return masks, thr

    def mean_scores(self, params, bstats):
        """IterSNIP scores averaged over the clients that hold data."""
        s, o = self.cfg.sparsity, self.cfg.optim
        total, wsum = None, 0
        for c, rows in self.client_rows(range(self.num_clients)):
            n = rows.n
            if n == 0:  # no rows: weighs 0 in the mean
                continue
            idx = self.snip_idx_for(c, n) if self.snip_idx_for else None
            sc = iter_snip_scores(self.trainer, params, bstats, rows.X,
                                  rows.y, n, s.itersnip_iterations,
                                  o.batch_size,
                                  stratified=s.stratified_sampling,
                                  idx_stack=idx)
            total = sc if total is None else {k: total[k] + sc[k]
                                              for k in total}
            wsum += 1
        return {k: v / max(wsum, 1) for k, v in total.items()}

    def wire_masks(self, ref):
        """The mask handoff: the phase-1 mask over the parameters, all ones
        over the BatchNorm statistics (both endpoints hold it, so the codec
        ships no bitmap and no top-k select runs)."""
        return {k: self._masks[k] if k in self._masks
                else torch.ones_like(v) for k, v in ref.items()}

    # ---------- phase 2: one masked round ----------

    def run_round(self, round_idx, params, bstats, per_params, per_bstats,
                  masks, sampled):
        """Local training of the sampled clients, FedAvg, personal update.
        Returns ``(params, bstats, per_params, per_bstats, loss, n_bad)``."""
        new_p, new_b, loss, n_bad, (ups_p, ups_b) = self.train_and_aggregate(
            round_idx, params, bstats, sampled, self.round_lr(round_idx),
            mask=masks)
        if self.health_on:  # a fixed mask: its density, overlap 1
            self.note_health(round_program.mask_health_stats(masks, None))
        real = self.n_train[sampled] > 0
        per_params = self.scatter_sampled_rows(per_params, ups_p, sampled, real)
        per_bstats = self.scatter_sampled_rows(per_bstats, ups_b, sampled, real)
        return new_p, new_b, per_params, per_bstats, loss, n_bad

    def window_round(self, carry, round_idx, sampled):
        *carry, loss, n_bad = self.run_round(round_idx, *carry, self._masks,
                                             sampled)
        return tuple(carry), {"loss": loss, "n_bad": n_bad}

    def train(self, init_state=None, masks=None) -> dict:
        """The whole run. ``init_state``: initial ``(params, bstats)``
        (default: :meth:`init_global_state`); ``masks``: a phase-1 mask to
        train under instead of computing one. A run resumed from a
        checkpoint takes its mask from it: phase 1 is not run again."""
        cfg = self.cfg
        params, bstats = self.start_state(init_state)
        start, restored = self.restore_checkpoint()
        if restored is not None:
            masks = restored["masks"]
        t0 = time.perf_counter()
        self.plan_walks(start,
                        before=[("train", tuple(range(self.num_clients)))]
                        if masks is None else [])
        if masks is None:
            masks, thr = self.generate_global_mask(params, bstats)
        else:
            masks = {k: v.to(self.device) for k, v in masks.items()}
            thr = None
        self._masks = masks
        density = float(mask_density(masks))
        phase1_seconds = time.perf_counter() - t0
        self.announce.info("global SNIP mask density = %.4f (target %.4f)",
                           density, cfg.sparsity.dense_ratio)
        self.stat_info["mask_density"] = density
        flops_per_sample = flops_ops.count_training_flops_per_sample(
            self.trainer.model, self.sample_shape,
            flops_ops.densities_from_masks(masks))
        # communicated parameters per client per round: the mask's nonzero
        # count (ones on the leaves that are not masked)
        comm_per_client = flops_ops.count_communication_params(masks)
        per_params, per_bstats = self.broadcast_states(params, bstats,
                                                       self.num_clients)
        history, round_seconds = [], []
        carry = (params, bstats, per_params, per_bstats)
        if restored is not None:
            history[:] = restored["history"]
            carry = self.carry_from(restored)

        def on_round(r, carry, row, seconds, sampled):
            round_seconds.append(seconds)
            entry = {"round": r, "train_loss": row["loss"]}
            n_samples = float(np.sum(self.n_train[sampled]))
            self.stat_info["sum_training_flops"] += (
                flops_per_sample * cfg.optim.epochs * n_samples)
            self.stat_info["sum_comm_params"] += comm_per_client * len(sampled)
            if self.is_eval_round(r):
                m = self.eval_global(*carry[:2])
                mp = self.eval_personalized(*carry[2:])
                self.stat_info["global_test_acc"].append(m["acc"])
                self.stat_info["person_test_acc"].append(mp["acc"])
                self.metrics(r, train_loss=row["loss"], **m,
                             personal_acc=mp["acc"])
                entry.update(m, personal_acc=mp["acc"])
            self.announce.info("round %d: %s", r, entry)
            history.append(entry)

        params, bstats, per_params, per_bstats = self.run_rounds(
            carry, on_round, history, start)
        m_global = self.eval_global(params, bstats)
        m_person = self.eval_personalized(per_params, per_bstats)
        self.metrics(-1, global_=m_global, personal=m_person)
        return {"params": params, "batch_stats": bstats, "masks": masks,
                "threshold": thr, "mask_density": density,
                "phase1_seconds": phase1_seconds, "history": history,
                "round_seconds": round_seconds,
                "per_params": per_params, "per_bstats": per_bstats,
                "final_global": m_global, "final_personal": m_person}
