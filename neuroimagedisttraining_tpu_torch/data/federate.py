"""FederatedData: the federation's data as padded client stacks on the
device.

``X[C, Nmax, D, H, W]`` stays uint8 (the cohort's 8-bit volumes) and is
cast raw to float32 per batch by the trainer; ``y[C, Nmax]`` int32 and the
true counts ``n[C]`` (also kept on the host as numpy, where the Python
client loop reads them). A validation split (``X_val``, ``y_val``,
``n_val``; FedFomo's) is carved out of each client's training rows where
``val_fraction > 0``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.data.partition import site_partition


@dataclass
class FederatedData:
    X_train: torch.Tensor   # [C, Ntr_max, D, H, W] uint8
    y_train: torch.Tensor   # [C, Ntr_max] int32
    n_train: np.ndarray     # [C] true sample counts (host)
    X_test: torch.Tensor
    y_test: torch.Tensor
    n_test: np.ndarray
    X_val: torch.Tensor | None = None
    y_val: torch.Tensor | None = None
    n_val: np.ndarray | None = None

    @property
    def num_clients(self) -> int:
        return int(self.X_train.shape[0])


def _stack_pad(X: np.ndarray, y: np.ndarray, idx_map: dict[int, np.ndarray]):
    C = len(idx_map)
    nmax = max(1, max(len(v) for v in idx_map.values()))
    Xs = np.zeros((C, nmax) + X.shape[1:], dtype=X.dtype)
    ys = np.zeros((C, nmax), dtype=np.int32)
    ns = np.zeros((C,), dtype=np.int64)
    for c in range(C):
        idx = idx_map[c]
        Xs[c, : len(idx)] = X[idx]
        ys[c, : len(idx)] = y[idx]
        ns[c] = len(idx)
    return Xs, ys, ns


def build_federated_data(X: np.ndarray, y: np.ndarray,
                         train_map: dict[int, np.ndarray],
                         test_map: dict[int, np.ndarray],
                         device: torch.device,
                         val_map: dict[int, np.ndarray] | None = None
                         ) -> FederatedData:
    """Stack, pad and move the federation to ``device`` (with the
    validation rows of ``val_map``, where given)."""
    put = lambda a: torch.from_numpy(a).to(device)
    Xtr, ytr, ntr = _stack_pad(X, y, train_map)
    Xte, yte, nte = _stack_pad(X, y, test_map)
    val = {}
    if val_map is not None:
        Xv, yv, nv = _stack_pad(X, y, val_map)
        val = dict(X_val=put(Xv), y_val=put(yv), n_val=nv)
    return FederatedData(X_train=put(Xtr), y_train=put(ytr), n_train=ntr,
                         X_test=put(Xte), y_test=put(yte), n_test=nte, **val)


def carve_val_split(train_map: dict[int, np.ndarray], val_fraction: float,
                    seed: int) -> tuple[dict, dict]:
    """``(val_map, train_map)``: each client's training rows shuffled by
    one ``RandomState(seed + 1)`` stream across the clients in order, the
    first ``max(1, int(n * val_fraction))`` of them held out for
    validation."""
    val_map, new_train = {}, {}
    rs = np.random.RandomState(seed + 1)
    for c, idx in train_map.items():
        idx = np.array(idx, copy=True)
        rs.shuffle(idx)
        nv = max(1, int(len(idx) * val_fraction))
        val_map[c], new_train[c] = idx[:nv], idx[nv:]
    return val_map, new_train


def federation_maps(site: np.ndarray, seed: int = 42,
                    val_fraction: float = 0.0):
    """``(train_map, test_map, val_map, info)``: the site clients' rows,
    with a validation split carved where ``val_fraction > 0`` (``val_map``
    None otherwise). The resident and the streamed federation both take
    their rows from here, so the two see the same train, test and
    validation rows (the reference package's ``__main__.py:607-636``)."""
    train_map, test_map, sites = site_partition(site, seed=seed)
    val_map = None
    if val_fraction > 0:
        val_map, train_map = carve_val_split(train_map, val_fraction, seed)
    info = {"partition_method": "site", "sites": sites.tolist(),
            "client_num": len(train_map),
            "train_counts": [int(len(train_map[c])) for c in sorted(train_map)]}
    return train_map, test_map, val_map, info


def federate_cohort(data: dict[str, np.ndarray], device: torch.device,
                    seed: int = 42, val_fraction: float = 0.0
                    ) -> tuple[FederatedData, dict]:
    """Partition a cohort ``{X, y, site}`` into site clients on
    ``device``, carving a validation split where ``val_fraction > 0``."""
    train_map, test_map, val_map, info = federation_maps(
        data["site"], seed, val_fraction)
    fed = build_federated_data(data["X"], data["y"], train_map, test_map,
                               device, val_map=val_map)
    return fed, info
