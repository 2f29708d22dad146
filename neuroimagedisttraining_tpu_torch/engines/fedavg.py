"""FedAvg: classical federated averaging, with the reference's final
fine-tune. Its checkpoint holds ``params``, ``batch_stats`` and
``history``; a rollback restores its global model.

A round samples clients (``np.random.seed(round)``, as the reference
does; crashed clients of the fault schedule leave the cohort), trains each
sampled client from the round's global model, and averages their uploads
weighted by sample count (a non-finite upload is dropped), through the
round's tail: the Byzantine attack, the wire codec with per-client error
feedback, the defense (engines/base.py ``defended_aggregate``). The global model is evaluated every ``frequency_of_the_test``
rounds and at the last round. After the last round every client fine-tunes
the aggregated model on its own rows at ``round_lr(-1)``, i.e.
``lr / lr_decay`` (the reference passes round -1 there), which gives the
personal models; then the global and personal models are evaluated.

Streamed, each round walks its sampled clients in chunks and the
fine-tune walks every client's training rows; the personal models are
kept (a model is 10 MB on the card), so the evaluations walk the test rows
after the fine-tune (the reference package's ``engines/fedavg.py:398-490``
walks the two side by side and drops each personal model).

``_prox_kwargs`` ties the local objective to the round's incoming global
model; FedAvg adds nothing, FedProx (engines/fedprox.py) its proximal pull.
"""

from __future__ import annotations

import time

from neuroimagedisttraining_tpu_torch.core import robust
from neuroimagedisttraining_tpu_torch.engines.base import FederatedEngine
from neuroimagedisttraining_tpu_torch.engines.program import RoundStages


class FedAvgEngine(FederatedEngine):
    name = "fedavg"
    final_walks = ("train", "test", "test")
    supports_byz_faults = True
    supports_wire_codec = True
    supports_secure_quant = True
    wire_uses_ef = True
    supported_defenses = robust.DEFENSES
    supports_cohort_sharding = True
    supports_fused_streaming = True
    ckpt_slots = ("params", "batch_stats")
    rollback_slots = True
    takes_preempt = True

    def round_stages(self):
        return RoundStages()

    def _prox_kwargs(self, global_params) -> dict:
        """Extra ``local_train`` arguments for the round's local training."""
        return {}

    def run_round(self, round_idx, params, bstats, sampled):
        """Local training of the sampled clients and FedAvg. Returns
        ``(params, bstats, loss, n_bad)``."""
        new_p, new_b, loss, n_bad, _ = self.train_and_aggregate(
            round_idx, params, bstats, sampled, self.round_lr(round_idx),
            **self._prox_kwargs(params))
        return new_p, new_b, loss, n_bad

    def window_round(self, carry, round_idx, sampled):
        params, bstats, loss, n_bad = self.run_round(round_idx, *carry,
                                                     sampled)
        return (params, bstats), {"loss": loss, "n_bad": n_bad}

    def finetune(self, params, bstats):
        """Every client trains the aggregated model for ``epochs`` at
        ``round_lr(-1)``: the personal ``(params, bstats)`` lists."""
        lr = self.round_lr(-1)
        out = self.map_clients(
            lambda c, rows: self.client_train(
                self.cfg.fed.comm_round, c, rows, params, bstats, lr,
                self.cfg.optim.epochs),
            range(self.num_clients))
        return [o[0] for o in out], [o[1] for o in out]

    def train(self, init_state=None) -> dict:
        """The whole run from ``init_state`` (default
        :meth:`init_global_state`)."""
        cfg = self.cfg
        history, round_seconds = [], []

        def on_round(r, carry, row, seconds, sampled):
            round_seconds.append(seconds)
            if self.is_eval_round(r):
                m = self.eval_global(*carry)
                self.stat_info["global_test_acc"].append(m["acc"])
                self.metrics(r, train_loss=row["loss"], **m)
                history.append({"round": r, "train_loss": row["loss"], **m})
                self.announce.info("round %d: %s", r, history[-1])

        self._register_reflexes()
        start, carry = self.resume(self.start_state(init_state), history)
        params, bstats = self.run_rounds(carry, on_round, history, start)
        t0 = time.perf_counter()
        per_params, per_bstats = self.finetune(params, bstats)
        self._sync()
        finetune_seconds = time.perf_counter() - t0
        m_global = self.eval_global(params, bstats)
        m_person = self.eval_personalized(per_params, per_bstats)
        self.stat_info["person_test_acc"].append(m_person["acc"])
        self.metrics(-1, global_=m_global, personal=m_person)
        return {"params": params, "batch_stats": bstats,
                "personal": {"params": per_params, "batch_stats": per_bstats},
                "history": history, "final_global": m_global,
                "final_personal": m_person, "round_seconds": round_seconds,
                "finetune_seconds": finetune_seconds}
