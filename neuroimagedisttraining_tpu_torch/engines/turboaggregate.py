"""TurboAggregate: FedAvg with secure aggregation by additive secret shares
over GF(p).

Sampling, local training, the final fine-tune and the accounting are
FedAvg's (engines/fedavg.py). Only the aggregation of the parameters
changes: a non-finite upload is swapped for the broadcast model at weight
0, the clip-family defense (``--defense norm_diff_clipping | weak_dp``)
clips each client's parameters, each sampled client's upload is
multiplied by its weight ``w / sum w``
(float32), and every parameter leaf goes through the share stage: each
client's weighted leaf is quantized into GF(p) at ``mpc_frac_bits``
fraction bits, split into ``mpc_n_shares`` additive shares, each share
slot summed over the clients before any two slots combine, and the sum
dequantized. The server never holds a client's update in the clear. The
shares sum to the quantized plain sum mod p, so the aggregate differs from
FedAvg's only by fixed-point rounding (``2^-mpc_frac_bits`` a client and
parameter). The BatchNorm stats are not secret and take the plain weighted
mean.

``mpc_backend="device"`` runs the stage as torch operations on the
device (``ops/mpc_device.py``), masks from a ``torch.Generator`` seeded a
call; ``"host"`` runs the numpy stage of ``ops/mpc.py`` on the host (one
read of the weighted uploads and one upload of the aggregate a round),
masks from a seeded numpy generator. The aggregate does not depend on the
masks.

``--secure_quant`` passes the startup checks (the flag comes with FedAvg)
and changes nothing: the round keeps this share stage, as in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.core import robust
from neuroimagedisttraining_tpu_torch.engines.fedavg import FedAvgEngine
from neuroimagedisttraining_tpu_torch.ops import mpc, mpc_device

MPC_BACKENDS = ("device", "host")


class TurboAggregateEngine(FedAvgEngine):
    name = "turboaggregate"
    # the server never sees a client's update in the clear: no order
    # statistic to select over, no codec over the field embedding, and no
    # attack stage; the clip family composes (each client clips its own
    # update before sharing it)
    supports_byz_faults = False
    supports_wire_codec = False
    supported_defenses = robust.CLIP_DEFENSES
    # the round crosses the host at the MPC share boundary every round
    supports_cohort_sharding = False

    def round_stages(self):
        return None

    def cohort_fallback_key(self) -> str | None:
        return "mpc-host-boundary"

    def fused_fallback_key(self) -> str | None:
        return "mpc-host-stage"

    def __init__(self, cfg, data, trainer, perms_for=None, stream=None,
                 mesh=None):
        super().__init__(cfg, data, trainer, perms_for, stream=stream,
                         mesh=mesh)
        if cfg.fed.mpc_backend not in MPC_BACKENDS:
            raise ValueError(f"unknown mpc_backend {cfg.fed.mpc_backend!r} "
                             f"(have {MPC_BACKENDS})")
        #: share-stage calls so far: each call's masks are seeded anew
        self.mpc_calls = 0

    def secure_aggregate(self, weighted: dict[str, torch.Tensor]
                         ) -> dict[str, torch.Tensor]:
        """The sum over clients of each weighted, client-stacked leaf
        ``{name: [S, ...]}`` through the share stage of ``mpc_backend``."""
        f = self.cfg.fed
        seed = self.cfg.seed * 7919 + self.mpc_calls
        self.mpc_calls += 1
        if f.mpc_backend == "device":
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return mpc_device.secure_aggregate_tree(
                weighted, gen, f.mpc_n_shares, frac_bits=f.mpc_frac_bits)
        rng = np.random.default_rng(seed)
        S = next(iter(weighted.values())).shape[0]
        sizes = [v[0].numel() for v in weighted.values()]
        flat = torch.cat([v.reshape(S, -1) for v in weighted.values()], 1)
        host = flat.cpu().numpy()  # one device read of every leaf
        agg = np.concatenate([
            mpc.secure_sum(x, n_shares=f.mpc_n_shares,
                           frac_bits=f.mpc_frac_bits, rng=rng
                           ).astype(np.float32)
            for x in np.split(host, np.cumsum(sizes)[:-1], axis=1)])
        agg = torch.from_numpy(agg).to(self.device)  # one upload
        return {k: x.reshape(v.shape[1:]) for (k, v), x in
                zip(weighted.items(), torch.split(agg, sizes))}

    def run_round(self, round_idx, params, bstats, sampled):
        """Local training of the sampled clients, the share stage over
        their weighted parameters and the plain weighted mean of their
        BatchNorm stats. Returns ``(params, bstats, loss, n_bad)``."""
        ups_p, ups_b, losses = self.train_sampled(
            round_idx, params, bstats, sampled, self.round_lr(round_idx))
        ns = self.to_device(self.n_train[sampled])
        ups_p, ups_b, w, loss, n_bad = self.guard_uploads(
            ups_p, ups_b, params, bstats, ns, losses)
        f = self.cfg.fed
        noises = ([self.noise_for("weak_dp", round_idx, int(c), params)
                   for c in sampled] if f.defense_type == "weak_dp"
                  else None)
        ups_p = robust.defend_stacked(ups_p, params, defense=f.defense_type,
                                      norm_bound=f.norm_bound,
                                      stddev=f.stddev, noises=noises)
        wn = w / torch.clamp(torch.sum(w), min=1e-12)
        weighted = {}
        for k in ups_p[0]:
            x = torch.stack([up[k] for up in ups_p]).to(torch.float32)
            weighted[k] = x * wn.reshape((-1,) + (1,) * (x.dim() - 1))
        new_params = self.secure_aggregate(weighted)
        return new_params, self.aggregate(ups_b, w), loss, n_bad
