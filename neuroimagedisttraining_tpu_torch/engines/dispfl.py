"""DisPFL: decentralized personalized sparse training with masks that
evolve every round.

- Start: each maskable layer's sparsity by ERK (or uniform) at
  ``dense_ratio``; every client starts from one random mask, or one of its
  own under ``different_initial``; ``diff_spa`` cycles the clients'
  densities through 0.2, 0.4, 0.6, 0.8, 1.0. A client's first personal
  model is the masked initial model.
- Each round every client is active with probability ``active``
  (``faults/schedule.py``). An active client mixes with its neighbours
  (``cs``: ``random`` draws ``client_num_per_round`` others, ``ring`` its
  two ring neighbours, ``full`` every active client, ``self`` none; at
  full participation every client), an inactive one with itself only.
- Consensus: per weight, the sum of the neighbours' models over the count
  of neighbours whose shared mask keeps it (0 where none does), masked
  again with the client's own mask; BatchNorm stats are the neighbours'
  mean. Inactive clients train as well.
- Every client trains its mixed model under its mask. Then, unless
  ``static``, its mask evolves: a one-batch dense gradient in evaluation
  mode (``trainer.eval_grad``), ``fire_mask`` of the smallest weights and
  ``regrow_mask`` of as many dead entries by the largest gradient (at
  random under ``dis_gradient_check``). Each layer keeps its nonzero count.
- The masks the neighbours mix against next round are this round's masks
  before evolution.

Streamed, a round walks every client's training rows in chunks, and the
gradient probe takes its rows from the client's chunk (the reference
package's ``engines/dispfl.py:349-447``).

``perms_for`` (engines/base.py) and ``screen_idx_for(round, client,
n_valid)`` may supply the epoch permutations and the gradient probe's rows
(the tests feed the reference's draws); by default both come from the
trainer's generator. The run ends with the all-pairs Hamming matrix of the
final masks (and the masks themselves in ``stat_info`` under
``save_masks``). ``stat_info`` counts, per gossip edge, the neighbour's
nonzero weights plus its dense leaves, and the sparse local epochs' FLOPs
at each client's ERK densities plus the dense probe.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.engines.base import FederatedEngine
from neuroimagedisttraining_tpu_torch.obs import compute as obs_compute
from neuroimagedisttraining_tpu_torch.faults.schedule import activity_mask
from neuroimagedisttraining_tpu_torch.ops import flops as flops_ops
from neuroimagedisttraining_tpu_torch.ops import masks as M


DIFF_SPA_CYCLE = (0.2, 0.4, 0.6, 0.8, 1.0)


class DisPFLEngine(FederatedEngine):
    name = "dispfl"
    trains_sampled = False

    def __init__(self, cfg, data, trainer, perms_for=None, stream=None,
                 mesh=None, screen_idx_for=None):
        super().__init__(cfg, data, trainer, perms_for, stream=stream,
                         mesh=mesh)
        self.screen_idx_for = screen_idx_for

    # ---------- start ----------

    def sparsities(self, params, dense_ratio: float) -> dict[str, float]:
        """Each maskable layer's sparsity at ``dense_ratio`` (ERK, or
        uniform under ``--uniform``)."""
        s = self.cfg.sparsity
        return M.calculate_sparsities(
            params, "uniform" if s.uniform else "ERK",
            dense_ratio=dense_ratio, erk_power_scale=s.erk_power_scale)

    def init_masks_all(self, params) -> tuple[list, list[float]]:
        """Every client's initial mask and target density, drawn from a CPU
        generator seeded ``seed + 23`` (the same masks on every device)."""
        s = self.cfg.sparsity
        gen = torch.Generator().manual_seed(self.cfg.seed + 23)
        cpu = {k: torch.empty(v.shape) for k, v in params.items()}
        w_spa = [s.dense_ratio] * self.num_clients
        if s.diff_spa:
            w_spa = [DIFF_SPA_CYCLE[i % len(DIFF_SPA_CYCLE)]
                     for i in range(self.num_clients)]
        if s.diff_spa or s.different_initial:
            masks = [M.init_masks(gen, cpu, self.sparsities(params, dr))
                     for dr in w_spa]
        else:
            one = M.init_masks(gen, cpu, self.sparsities(params,
                                                         s.dense_ratio))
            masks = [one] * self.num_clients
        return ([{k: v.to(self.device) for k, v in m.items()} for m in masks],
                w_spa)

    # ---------- the round's graph (host) ----------

    def cohort_fallback_key(self) -> str | None:
        return "gossip-mesh-collectives"

    def active_draw(self, round_idx: int) -> np.ndarray:
        """Each real client's Bernoulli(``active``) draw; padding clients
        are inactive."""
        out = np.zeros(self.num_clients, bool)
        out[:self.real_clients] = activity_mask(
            self.cfg.seed, round_idx, self.real_clients, self.cfg.fed.active)
        return out

    def adjacency(self, round_idx: int, active: np.ndarray) -> np.ndarray:
        """``A[c]``: client ``c`` and its neighbours (only itself where
        inactive). ``random`` draws from a ``RandomState`` seeded by (seed,
        round, client) and draws again while the client drew itself."""
        C, total = self.num_clients, self.real_clients
        per_round = min(self.cfg.fed.client_num_per_round, total)
        cs = self.cfg.fed.cs
        A = np.zeros((C, C), np.float32)
        for c in range(total):
            A[c, c] = 1.0
            if not active[c] or cs == "self":
                continue
            if total == per_round:
                A[c, :total] = 1.0
                continue
            if cs == "random":
                rs = np.random.RandomState(
                    (self.cfg.seed * 100003 + round_idx * 1009 + c)
                    % (2**31 - 1))
                nei = rs.choice(range(total), per_round, replace=False)
                while c in nei:
                    nei = rs.choice(range(total), per_round, replace=False)
            elif cs == "ring":
                nei = np.asarray([(c - 1) % total, (c + 1) % total])
            elif cs == "full":
                nei = np.flatnonzero(active[:total])
                nei = nei[nei != c]
            else:
                raise ValueError(f"unknown cs {cs!r}")
            A[c, nei] = 1.0
        for c in range(total, C):
            A[c, c] = 1.0
        return A

    # ---------- the round (device) ----------

    def consensus(self, per_params, per_bstats, masks_local, masks_shared,
                  A: np.ndarray):
        """Each client's mixed ``(params, bstats)``: per weight the
        neighbours' sum over their shared masks' overlap count (0 where it
        is 0), times the client's own mask; BatchNorm stats the
        neighbours' mean. The sums run over the mesh where the adjacency's
        pattern allows (:meth:`gossip_mixer`)."""
        At = self.to_device(A)
        deg = At.sum(1)
        mixer = self.gossip_mixer(A)

        def mix(states, k):
            return mixer(torch.stack([st[k] for st in states]))

        C = len(per_params)
        w_local = [{} for _ in range(C)]
        for k in per_params[0]:
            counts = mix(masks_shared, k)
            w = torch.where(counts > 0,
                            mix(per_params, k) / torch.clamp(counts, min=1.0),
                            torch.zeros_like(counts))
            w = w * torch.stack([m[k] for m in masks_local])
            for c in range(C):
                w_local[c][k] = w[c]
        b_mixed = [{} for _ in range(C)]
        for k in per_bstats[0]:
            b = mix(per_bstats, k)
            b = b / deg.reshape((-1,) + (1,) * (b.dim() - 1))
            for c in range(C):
                b_mixed[c][k] = b[c]
        return w_local, b_mixed

    def client_generator(self, round_idx: int, c: int, n: int):
        """The generator of client ``c``'s probe rows and regrowth: the
        trainer's, but for a client of no rows (a mesh's padding client) a
        generator of its own, seeded by the run's seed, the round and the
        client, so padding moves no real client's draws."""
        if n > 0:
            return self.trainer.generator
        return torch.Generator(device=self.device).manual_seed(
            (self.cfg.seed * 1_000_003 + round_idx * 1_009 + c) % 2 ** 63)

    def probe_rows(self, round_idx: int, c: int, n: int,
                   generator=None) -> torch.Tensor:
        """The gradient probe's ``batch_size`` rows of client ``c``, drawn
        from ``generator`` (default: :meth:`client_generator`'s)."""
        if self.screen_idx_for is not None:
            return self.screen_idx_for(round_idx, c, n).to(self.device)
        if generator is None:
            generator = self.client_generator(round_idx, c, n)
        return torch.randint(0, max(n, 1), (self.cfg.optim.batch_size,),
                             generator=generator, device=self.device)

    def evolve(self, round_idx: int, c: int, rows, params, bstats, mask):
        """Fire and regrow ``mask`` from client ``c``'s trained model and a
        one-batch dense gradient in evaluation mode on its training
        ``rows``."""
        s = self.cfg.sparsity
        gen = self.client_generator(round_idx, c, rows.n)
        grad = None
        if not s.dis_gradient_check:
            idx = self.probe_rows(round_idx, c, rows.n, gen)
            grad = self.trainer.eval_grad(params, bstats, rows.X[idx],
                                          rows.y[idx])
        fired, num_remove = M.fire_mask(mask, params, round_idx,
                                        self.cfg.fed.comm_round,
                                        anneal_factor=s.anneal_factor)
        return M.regrow_mask(fired, num_remove, grad, generator=gen,
                             dis_gradient_check=s.dis_gradient_check)

    def run_round(self, round_idx: int, per_params, per_bstats, masks_local,
                  masks_shared, A: np.ndarray):
        """Consensus, every client's local training and mask evolution.
        Returns ``(per_params, per_bstats, masks_local, masks_shared,
        dist_self, loss)``; the last two on the device."""
        w_local, b_mixed = self.consensus(per_params, per_bstats,
                                          masks_local, masks_shared, A)
        lr = self.round_lr(round_idx)
        new_p, new_b, new_m, losses = [], [], [], []
        for c, rows in self.client_rows(range(self.num_clients)):
            p, b, loss = self.client_train(round_idx, c, rows, w_local[c],
                                           b_mixed[c], lr,
                                           self.cfg.optim.epochs,
                                           mask=masks_local[c])
            new_p.append(p)
            new_b.append(b)
            losses.append(loss)
            new_m.append(masks_local[c] if self.cfg.sparsity.static else
                         self.evolve(round_idx, c, rows, p, b,
                                     masks_local[c]))
        dist_self = torch.stack([M.mask_hamming_distance(a, b) for a, b in
                                 zip(masks_shared, masks_local)])
        real = self.to_device((self.n_train > 0).astype(np.float32))
        loss = (torch.sum(torch.stack(losses) * real)
                / torch.clamp(real.sum(), min=1.0))
        return new_p, new_b, new_m, masks_local, dist_self, loss

    # ---------- the run ----------

    def flops_per_round(self, params, w_spa) -> float:
        """The sparse local epochs at each real client's ERK densities plus
        its dense one-batch probe."""
        cfg = self.cfg
        shape = self.sample_shape
        model = self.trainer.model
        full = flops_ops.count_training_flops_per_sample(model, shape)
        by_dr = {dr: flops_ops.count_training_flops_per_sample(
            model, shape, {k: 1.0 - v for k, v in
                           self.sparsities(params, dr).items()})
            for dr in sorted(set(w_spa))}
        n = self.n_train
        return sum(cfg.optim.epochs * float(n[c]) * by_dr[w_spa[c]]
                   + cfg.optim.batch_size * full
                   for c in range(self.real_clients))

    def train(self, init_state=None, masks=None) -> dict:
        """The whole run from ``init_state`` (default
        :meth:`init_global_state`); ``masks``: the clients' initial masks
        instead of :meth:`init_masks_all`'s draw."""
        cfg = self.cfg
        params, bstats = self.start_state(init_state)
        masks_local, w_spa = self.init_masks_all(params)
        if masks is not None:
            masks_local = [{k: v.to(self.device) for k, v in m.items()}
                           for m in masks]
        per_params = [{k: v * m[k] for k, v in params.items()}
                      for m in masks_local]
        _, per_bstats = self.broadcast_states(params, bstats,
                                              self.num_clients)
        masks_shared = masks_local
        real = self.real_clients
        # fire and regrow keep each layer's nonzero count, so a client's
        # communicated volume is fixed at the start
        n_dense = sum(v.numel() for k, v in params.items()
                      if not M.is_weight_kernel(k, v))
        comm_per_client = np.array(
            torch.stack([M.mask_nnz(m) for m in masks_local[:real]]).cpu(),
            dtype=np.float64) + n_dense
        flops_per_round = self.flops_per_round(params, w_spa)
        history, round_seconds = [], []
        start, restored = self.restore_checkpoint()
        if restored is not None:
            per_params, per_bstats = (restored["per_params"],
                                      restored["per_bstats"])
            masks_local, masks_shared = (restored["masks_local"],
                                         restored["masks_shared"])
            history[:] = restored["history"]
        self._arm_compute_profiler()
        for r in range(start, cfg.fed.comm_round):
            self.plan_walks(r)
            active = self.active_draw(r)
            A = self.adjacency(r, active)
            self.announce.info("round %d: active %s", r,
                               np.flatnonzero(active[:real]).tolist())
            t0 = time.perf_counter()
            (per_params, per_bstats, masks_local, masks_shared, dist_self,
             loss) = self.run_round(r, per_params, per_bstats, masks_local,
                                    masks_shared, A)
            loss_h = self.read_round(r, loss)
            self._sync()
            round_seconds.append(time.perf_counter() - t0)
            obs_compute.note_dispatch(self.name, "round", round_seconds[-1],
                                      rounds=1)
            if not cfg.sparsity.static:
                self.warn_if_masks_collapsed(masks_local, r)
            off = A[:real, :real].astype(np.float64)
            np.fill_diagonal(off, 0.0)
            self.stat_info["sum_comm_params"] += float(
                (off @ comm_per_client).sum())
            self.stat_info["sum_training_flops"] += flops_per_round
            if self.is_eval_round(r):
                mp = self.eval_personalized(per_params, per_bstats)
                change = float(dist_self[:real].sum())
                self.stat_info["person_test_acc"].append(mp["acc"])
                self.metrics(r, train_loss=loss_h, personal=mp,
                             mask_change=change)
                history.append({"round": r, "train_loss": loss_h,
                                "personal_acc": mp["acc"],
                                "mask_change": change})
                self.announce.info("round %d: %s", r, history[-1])
            self.publish_stat_info(r)
            self.maybe_checkpoint(r, {
                "per_params": per_params, "per_bstats": per_bstats,
                "masks_local": masks_local, "masks_shared": masks_shared,
                "history": history})
        dist_matrix = torch.stack([
            torch.stack([M.mask_hamming_distance(a, b)
                         for b in masks_local[:real]])
            for a in masks_local[:real]]).cpu().numpy()
        self.stat_info["mask_dis_matrix"] = dist_matrix.tolist()
        if cfg.sparsity.save_masks:
            self.stat_info["final_masks"] = {
                k: torch.stack([m[k] for m in masks_local]).cpu().numpy()
                .astype(bool) for k in masks_local[0]}
        m_person = self.eval_personalized(per_params, per_bstats)
        self.metrics(-1, personal=m_person)
        return {"personal_params": per_params,
                "personal_batch_stats": per_bstats, "masks": masks_local,
                "w_spa": w_spa, "history": history,
                "mask_dis_matrix": dist_matrix.tolist(),
                "final_personal": m_person, "round_seconds": round_seconds}
