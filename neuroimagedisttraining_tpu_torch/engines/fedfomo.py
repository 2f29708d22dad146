"""FedFomo: personalized client-to-client weighted aggregation.

- It needs a validation split of each client's training rows
  (``--val_fraction > 0``) and refuses to run without one.
- Every client trains from its own last personal model each round.
- Neighbour choice (``benefit_choose``): at full participation every
  client; otherwise a coin flip (``RandomState(seed * 131 + round * 17 +
  c)``) between the top ``fomo_m`` clients by accumulated ``p_choose``
  (the client's own entry zeroed, ``np.argsort``'s order) and a uniform
  draw that draws again while it contains the client; the client itself
  is appended.
- FedFomo weights at the round's (client, owner) pairs only: ``w[c, n] =
  (L_c(own last model) - L_c(model n)) / ||theta_n - theta_c||`` on client
  ``c``'s validation rows, the owners' last models (the client's own
  entry compares its freshly trained model), 0 where the distance is 0.
  Entries off the round's adjacency keep their old weight (``1/real`` at
  the start); ``p_choose += weights`` (1 at the start).
- Aggregation: the weights through a ReLU, normalised over the
  neighbours and applied as a delta from the client's last model,
  ``last + B_off @ last + b_diag * new - rowsum * last``, for parameters
  and BatchNorm stats alike; with no positive weight a client keeps its
  last model.

Streamed, a round walks every client's training rows in chunks; the
validation rows, ``val_fraction``-small, are fetched to the device once
(``get_val_resident``) and stay, as the pairs read any client's (the
reference package's ``engines/fedfomo.py:60-75``).

The host reads ``p_choose`` once a round, in one device read at the top
of :meth:`run_round`, to choose the neighbours. ``stat_info`` counts the
training FLOPs of every client's epochs and the parameters of every model
transfer (each neighbour a client receives from).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.engines.base import FederatedEngine
from neuroimagedisttraining_tpu_torch.ops import flops as flops_ops

log = logging.getLogger(__name__)


class FedFomoEngine(FederatedEngine):
    name = "fedfomo"
    trains_sampled = False

    def __init__(self, cfg, data, trainer, perms_for=None, stream=None,
                 mesh=None):
        super().__init__(cfg, data, trainer, perms_for, stream=stream,
                         mesh=mesh)
        if stream is not None:
            if stream.val_map is None:
                raise ValueError(
                    "FedFomo streaming requires a val split: build the "
                    "StreamingFederation with val_map (val_fraction > 0)")
            X, y, _ = stream.get_val_resident()
            self._val = (X, y, stream.n_val)
        elif data.X_val is None:
            raise ValueError(
                "FedFomo requires a validation split: build the federation "
                "with val_fraction > 0 (--val_fraction)")
        else:
            self._val = (data.X_val, data.y_val, data.n_val)

    # ---------- the round's graph (host) ----------

    def benefit_choose(self, round_idx: int, c: int,
                       p_choose_row: np.ndarray) -> np.ndarray:
        """Client ``c``'s neighbours and itself (appended last)."""
        total = self.real_clients
        per_round = min(self.cfg.fed.client_num_per_round, total)
        if per_round == total:
            return np.arange(total)
        m = min(self.cfg.fed.fomo_m, per_round)
        rs = np.random.RandomState(self.cfg.seed * 131 + round_idx * 17 + c)
        if rs.random() >= 0.5:
            row = p_choose_row[:total].copy()
            row[c] = 0.0
            nei = np.argsort(row)[-m:]
        else:
            nei = rs.choice(range(total), m, replace=False)
            while c in nei:
                nei = rs.choice(range(total), m, replace=False)
        return np.append(nei, c)

    def adjacency(self, round_idx: int, p_choose: np.ndarray
                  ) -> tuple[np.ndarray, int]:
        """``(A, transfers)``: ``A[c]`` marks client ``c``'s neighbours and
        itself; ``transfers`` counts the models the clients receive."""
        C = self.num_clients
        A = np.zeros((C, C), np.float32)
        transfers = 0
        for c in range(self.real_clients):
            nei = np.unique(self.benefit_choose(round_idx, c, p_choose[c]))
            A[c, nei] = 1.0
            transfers += len(nei) - (1 if c in nei else 0)
        return A, transfers

    def pairs_from_adjacency(self, A: np.ndarray):
        """The (client, owner) pairs of the round's adjacency among the real
        clients, padded to ``real * (fomo_m + 1)`` (``real^2`` at full
        participation) with the pair (0, 0): ``(pair_c, pair_n,
        n_pairs)``."""
        real = self.real_clients
        per_round = min(self.cfg.fed.client_num_per_round, real)
        if per_round == real:
            P = real * real
        else:
            P = real * (min(self.cfg.fed.fomo_m, per_round) + 1)
        cs, ns = np.nonzero(A[:real, :real])
        assert len(cs) <= P, (len(cs), P)
        pair_c = np.zeros(P, np.int32)
        pair_n = np.zeros(P, np.int32)
        pair_c[: len(cs)] = cs
        pair_n[: len(ns)] = ns
        return pair_c, pair_n, len(cs)

    # ---------- the round (device) ----------

    def val_loss(self, c: int, params, bstats) -> torch.Tensor:
        """The mean loss of ``(params, bstats)`` on client ``c``'s
        validation rows (0 rows: 0)."""
        X, y, n = self._val
        valid = torch.arange(X.shape[1], device=self.device) < int(n[c])
        m = self.trainer.evaluate(params, bstats, X[c], y[c], valid)
        return m["test_loss"] / torch.clamp(m["test_total"], min=1.0)

    @staticmethod
    def sq_dist(a, b) -> torch.Tensor:
        """``||a - b||^2`` over every leaf, summed leaf by leaf."""
        return torch.sum(torch.stack([torch.sum((a[k] - b[k]) * (a[k] - b[k]))
                                      for k in a]))

    def fomo_aggregate(self, last_p, last_b, new_p, new_b, losses, weights,
                       p_choose, A: np.ndarray, pair_c, pair_n, n_pairs: int):
        """The validation losses and distances at the round's pairs, the
        weight update and the ReLU-normalised delta aggregation. Returns
        ``(per_params, per_bstats, weights, p_choose, loss)``, all on the
        device."""
        C = self.num_clients
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        L = [[zero] * C for _ in range(C)]
        D2 = [[zero] * C for _ in range(C)]
        for c, n in zip(pair_c[:n_pairs].tolist(), pair_n[:n_pairs].tolist()):
            L[c][n] = self.val_loss(c, last_p[n], last_b[n])
            D2[c][n] = self.sq_dist(last_p[n], last_p[c])
        loss_cur = torch.stack([L[c][c] for c in range(C)])  # own last model
        for c in range(C):
            L[c][c] = self.val_loss(c, new_p[c], new_b[c])
            D2[c][c] = self.sq_dist(new_p[c], last_p[c])
        Lmat = torch.stack([torch.stack(row) for row in L])
        D = torch.sqrt(torch.clamp(torch.stack([torch.stack(row)
                                                for row in D2]), min=0.0))
        At = self.to_device(A)
        w_new = torch.where(D > 0, (loss_cur[:, None] - Lmat)
                            / torch.clamp(D, min=1e-20),
                            torch.zeros_like(D))
        weights = torch.where(At > 0, w_new, weights)
        p_choose = p_choose + weights
        wpos = torch.clamp(weights, min=0.0) * At
        denom = torch.sum(wpos, dim=1)
        B = torch.where(denom[:, None] > 0,
                        wpos / torch.clamp(denom[:, None], min=1e-20),
                        torch.zeros_like(wpos))
        eye = torch.eye(C, dtype=torch.float32, device=self.device)
        B_off = B * (1.0 - eye)
        b_diag = torch.diagonal(B)
        rowsum = torch.sum(B, dim=1)

        def aggregate(last, new):
            out = [{} for _ in range(C)]
            for k in last[0]:
                lst = torch.stack([st[k] for st in last])
                nw = torch.stack([st[k] for st in new])
                shape = (-1,) + (1,) * (lst.dim() - 1)
                t1 = torch.einsum("cn,n...->c...", B_off, lst)
                x = (lst + t1 + b_diag.reshape(shape) * nw
                     - rowsum.reshape(shape) * lst)
                for c in range(C):
                    out[c][k] = x[c]
            return out

        real = self.to_device((self.n_train > 0).astype(np.float32))
        loss = (torch.sum(losses * real)
                / torch.clamp(torch.sum(real), min=1.0))
        return (aggregate(last_p, new_p), aggregate(last_b, new_b), weights,
                p_choose, loss)

    def run_round(self, round_idx: int, per_params, per_bstats, weights,
                  p_choose):
        """One round: ``p_choose`` read once to choose the neighbours,
        every client's local training from its last model, then
        :meth:`fomo_aggregate`. Returns ``(per_params, per_bstats, weights,
        p_choose, loss, transfers, n_pairs)``."""
        pch = p_choose.cpu().numpy()  # the round's one device read
        A, transfers = self.adjacency(round_idx, pch)
        pair_c, pair_n, n_pairs = self.pairs_from_adjacency(A)
        lr = self.round_lr(round_idx)
        new_p, new_b, losses = [], [], []
        for c, rows in self.client_rows(range(self.num_clients)):
            p, b, loss = self.client_train(round_idx, c, rows, per_params[c],
                                           per_bstats[c], lr,
                                           self.cfg.optim.epochs)
            new_p.append(p)
            new_b.append(b)
            losses.append(loss)
        out = self.fomo_aggregate(per_params, per_bstats, new_p, new_b,
                                  torch.stack(losses), weights, p_choose, A,
                                  pair_c, pair_n, n_pairs)
        return (*out, transfers, n_pairs)

    # ---------- the run ----------

    def train(self, init_state=None) -> dict:
        """The whole run from ``init_state`` (default
        :meth:`init_global_state`)."""
        cfg = self.cfg
        C = self.num_clients
        params, bstats = self.start_state(init_state)
        per_params, per_bstats = self.broadcast_states(params, bstats, C)
        weights = torch.full((C, C), 1.0 / max(self.real_clients, 1),
                             dtype=torch.float32, device=self.device)
        p_choose = torch.ones((C, C), dtype=torch.float32, device=self.device)
        flops_per_sample = flops_ops.count_training_flops_per_sample(
            self.trainer.model, self.sample_shape)
        n_params = sum(v.numel() for v in params.values())
        n_samples = float(np.sum(self.n_train[:self.real_clients]))
        history, round_seconds = [], []
        for r in range(cfg.fed.comm_round):
            self.plan_walks(r)
            t0 = time.perf_counter()
            (per_params, per_bstats, weights, p_choose, loss, transfers,
             n_pairs) = self.run_round(r, per_params, per_bstats, weights,
                                       p_choose)
            loss_h = self.read_round(r, loss)
            self._sync()
            round_seconds.append(time.perf_counter() - t0)
            log.info("round %d: %d neighbour evaluations", r, n_pairs)
            self.stat_info["sum_training_flops"] += (
                flops_per_sample * cfg.optim.epochs * n_samples)
            self.stat_info["sum_comm_params"] += float(transfers * n_params)
            if self.is_eval_round(r):
                mp = self.eval_personalized(per_params, per_bstats)
                self.stat_info["person_test_acc"].append(mp["acc"])
                self.metrics(r, train_loss=loss_h, personal=mp)
                history.append({"round": r, "train_loss": loss_h,
                                "personal_acc": mp["acc"]})
                log.info("round %d: %s", r, history[-1])
        m_person = self.eval_personalized(per_params, per_bstats)
        self.metrics(-1, personal=m_person)
        return {"personal_params": per_params,
                "personal_batch_stats": per_bstats, "weights": weights,
                "p_choose": p_choose, "history": history,
                "final_personal": m_person, "round_seconds": round_seconds}
