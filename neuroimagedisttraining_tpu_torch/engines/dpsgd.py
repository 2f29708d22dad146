"""D-PSGD: decentralized gossip SGD.

- Each round every real client picks its neighbours (``benefit_choose``):
  ``random`` reseeds numpy's global stream with ``round + client`` and
  draws ``client_num_per_round`` others, drawing again while it drew
  itself; ``ring`` its two ring neighbours; ``full`` every other client.
  At full participation every client mixes with all.
- Consensus: client ``c`` starts the round from the uniform mean over
  {neighbours ∪ c} of LAST round's personal models and BatchNorm stats,
  one row-stochastic mixing matrix ``M[C, C]`` a round applied as a dense
  ``einsum('cj,j...->c...')`` (padding clients keep themselves).
- Every client then trains from its consensus point. Under round-level DP
  (``dp_clip`` > 0) its update against that point is clipped to
  ``dp_clip`` and, with ``dp_sigma`` > 0, noised with
  ``N(0, (dp_sigma * dp_clip)^2)`` before anything leaves the client (the
  BatchNorm statistics untouched); ``record_privacy`` charges the RDP
  accountant at full participation.
- ``w_global``, the plain mean of the real clients' personal models, is
  the global model evaluated each evaluation round.
- After every round ``r`` with ``r % 100 == 99`` every client trains
  ``w_global`` for ``epochs`` at ``round_lr(-1)``; those models are
  evaluated, logged and dropped (the personal models do not change).

Streamed, a round walks every client's training rows in chunks, and the
every-100-rounds fine-tune is skipped, with a log line once: its models
are evaluated and dropped, and no training state depends on them (the
reference package's ``engines/dpsgd.py:462-470``).

``perms_for`` (engines/base.py) may supply the epoch permutations (the
fine-tune's under round -1); by default they come from the trainer's
generator. ``stat_info`` records the global accuracy at each evaluation.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.core import robust
from neuroimagedisttraining_tpu_torch.engines.base import FederatedEngine
from neuroimagedisttraining_tpu_torch.engines.program import RoundStages

log = logging.getLogger(__name__)

#: the fine-tune-from-global pass runs after rounds ``r % FINETUNE_EVERY ==
#: FINETUNE_EVERY - 1``
FINETUNE_EVERY = 100


def benefit_choose(round_idx: int, cur_clnt: int, total: int,
                   per_round: int, cs: str) -> np.ndarray:
    """Client ``cur_clnt``'s neighbours: numpy's global stream reseeded
    with ``round_idx + cur_clnt`` for ``random``, as the reference draws
    them."""
    if total == per_round:
        return np.arange(total)
    if cs == "random":
        num = min(per_round, total)
        np.random.seed(round_idx + cur_clnt)
        idx = np.random.choice(range(total), num, replace=False)
        while cur_clnt in idx:
            idx = np.random.choice(range(total), num, replace=False)
        return idx
    if cs == "ring":
        return np.asarray([(cur_clnt - 1) % total, (cur_clnt + 1) % total])
    if cs == "full":
        return np.delete(np.arange(total), cur_clnt)
    raise ValueError(f"unknown cs {cs!r}")


class DPSGDEngine(FederatedEngine):
    name = "dpsgd"
    trains_sampled = False
    supports_dp = True
    eval_walks = 2
    supports_cohort_sharding = True
    cohort_label = "decentralized cohort"
    ckpt_slots = ("per_params", "per_bstats", "g_params", "g_bstats")

    def round_stages(self):
        return RoundStages(gathers_cohort=False,
                           extra_hooked=self._finetune_hooked)

    @staticmethod
    def _finetune_hooked(r: int) -> bool:
        """The every-100-rounds fine-tune is a host hook: it ends a
        window."""
        return r % FINETUNE_EVERY == FINETUNE_EVERY - 1

    def round_sampling(self, round_idx):
        log.info("round %d: decentralized cohort", round_idx)
        return None

    def mixing_matrix(self, round_idx: int) -> np.ndarray:
        """Row ``c``: uniform weights over {neighbours(c) ∪ c} among the
        real clients; padding clients keep themselves."""
        C, total = self.num_clients, self.real_clients
        per_round = min(self.cfg.fed.client_num_per_round, total)
        M = np.zeros((C, C), np.float32)
        for c in range(total):
            nei = benefit_choose(round_idx, c, total, per_round,
                                 self.cfg.fed.cs)
            if total != per_round:
                nei = np.append(nei, c)
            nei = np.unique(nei)
            M[c, nei] = 1.0 / len(nei)
        for c in range(total, C):
            M[c, c] = 1.0
        return M

    def consensus(self, per_params, per_bstats, M: np.ndarray):
        """Every client's mixed ``(params, bstats)``: ``M`` applied to the
        clients' stacked leaves (over the mesh where its pattern allows,
        :meth:`gossip_mixer`)."""
        mixer = self.gossip_mixer(M)

        def mix(states):
            out = [{} for _ in states]
            for k in states[0]:
                x = mixer(torch.stack([st[k] for st in states]))
                for c in range(len(states)):
                    out[c][k] = x[c]
            return out

        return mix(per_params), mix(per_bstats)

    def global_mean(self, per_params, per_bstats):
        """``w_global``: the plain mean over the real clients of the
        personal ``(params, bstats)`` (the padding clients, last, are left
        out of the sum: the unpadded run's, bit for bit)."""
        R = len(np.trim_zeros(self.n_train, "b"))
        real = (self.n_train > 0).astype(np.float32)
        w = self.to_device((real / max(np.float32(real.sum()), 1.0))[:R])

        def mean(states):
            return {k: torch.einsum("c,c...->...", w,
                                    torch.stack([st[k] for st in states[:R]]))
                    for k in states[0]}

        return mean(per_params), mean(per_bstats)

    def run_round(self, round_idx: int, per_params, per_bstats,
                  M: np.ndarray):
        """Consensus, then every client's local training from its mixed
        model. Returns ``(per_params, per_bstats, loss)``, the loss the
        real clients' mean on the device."""
        mixed_p, mixed_b = self.consensus(per_params, per_bstats, M)
        lr = self.round_lr(round_idx)
        f = self.cfg.fed

        def train(c, rows):
            p, b, loss = self.client_train(round_idx, c, rows, mixed_p[c],
                                           mixed_b[c], lr,
                                           self.cfg.optim.epochs)
            if f.dp_clip > 0:
                p = robust.norm_diff_clip(p, mixed_p[c], f.dp_clip)
                if f.dp_sigma > 0:
                    p = robust.add_weak_dp_noise(
                        p, self.noise_for("dp", round_idx, c, p),
                        f.dp_sigma * f.dp_clip)
            return p, b, loss

        new_p, new_b, losses = map(list, zip(*self.map_clients(
            train, range(self.num_clients))))
        R = len(np.trim_zeros(self.n_train, "b"))
        real = self.to_device((self.n_train[:R] > 0).astype(np.float32))
        loss = (torch.sum(torch.stack(losses[:R]) * real)
                / torch.clamp(real.sum(), min=1.0))
        return new_p, new_b, loss

    def window_round(self, carry, round_idx, sampled):
        per_params, per_bstats = carry[:2]
        per_params, per_bstats, loss = self.run_round(
            round_idx, per_params, per_bstats, self.mixing_matrix(round_idx))
        g_params, g_bstats = self.global_mean(per_params, per_bstats)
        return (per_params, per_bstats, g_params, g_bstats), {"loss": loss}

    def finetune(self, g_params, g_bstats):
        """Every client trains ``w_global`` for ``epochs`` at
        ``round_lr(-1)`` (permutations of round -1): the fine-tuned
        ``(params, bstats)`` lists."""
        lr = self.round_lr(-1)
        ft_p, ft_b = [], []
        for c, rows in self.client_rows(range(self.num_clients)):
            p, b, _ = self.client_train(-1, c, rows, g_params, g_bstats, lr,
                                        self.cfg.optim.epochs)
            ft_p.append(p)
            ft_b.append(b)
        return ft_p, ft_b

    def train(self, init_state=None) -> dict:
        """The whole run from ``init_state`` (default
        :meth:`init_global_state`)."""
        cfg = self.cfg
        g_params, g_bstats = self.start_state(init_state)
        per_params, per_bstats = self.broadcast_states(g_params, g_bstats,
                                                       self.num_clients)
        history, round_seconds = [], []
        warned_skip = False

        def on_round(r, carry, row, seconds, sampled):
            nonlocal warned_skip
            round_seconds.append(seconds)
            per_params, per_bstats, g_params, g_bstats = carry
            if self.is_eval_round(r):
                mg = self.eval_global(g_params, g_bstats)
                mp = self.eval_personalized(per_params, per_bstats)
                self.stat_info["global_test_acc"].append(mg["acc"])
                self.metrics(r, train_loss=row["loss"], global_=mg,
                             personal=mp)
                history.append({"round": r, "train_loss": row["loss"],
                                "global_acc": mg["acc"],
                                "personal_acc": mp["acc"]})
                log.info("round %d: %s", r, history[-1])
            if (self._finetune_hooked(r) and self.stream is not None
                    and not warned_skip):
                warned_skip = True
                log.info("streaming run: skipping the every-100-rounds "
                         "fine-tune DIAGNOSTIC pass (its models are "
                         "evaluated then discarded; no training state "
                         "depends on it)")
            if self._finetune_hooked(r) and self.stream is None:
                ft_p, ft_b = self.finetune(g_params, g_bstats)
                mft = self.eval_personalized(ft_p, ft_b)
                self.metrics(-1, finetune_after_round=r,
                             finetune_personal=mft)
                log.info("fine-tune after round %d: %s", r, mft)

        start, carry = self.resume(
            (per_params, per_bstats, g_params, g_bstats), history)
        per_params, per_bstats, g_params, g_bstats = self.run_rounds(
            carry, on_round, history, start)
        return {"personal_params": per_params,
                "personal_batch_stats": per_bstats,
                "global_params": g_params, "global_batch_stats": g_bstats,
                "history": history,
                "final_global": self.eval_global(g_params, g_bstats),
                "round_seconds": round_seconds}
