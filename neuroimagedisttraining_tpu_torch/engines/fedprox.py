"""FedProx: FedAvg with a proximal term toward the global model in the
local objective, ``min_w F_c(w) + (mu / 2) * ||w - w_global||^2``, taken by
proximal-gradient splitting: after every SGD step
``w -= (lr * mu) * (w - w_global)``, where ``w_global`` is the round's
incoming global model and ``mu`` is the ``lamda`` flag. Everything else,
the final fine-tune included, is FedAvg's.
"""

from __future__ import annotations

from neuroimagedisttraining_tpu_torch.engines.fedavg import FedAvgEngine


class FedProxEngine(FedAvgEngine):
    name = "fedprox"

    def _prox_kwargs(self, global_params) -> dict:
        return {"prox_lamda": float(self.cfg.fed.lamda),
                "prox_ref": global_params}
