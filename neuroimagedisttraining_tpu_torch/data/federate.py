"""FederatedData: the federation's data as padded client stacks on the
device.

``X[C, Nmax, ...]`` keeps the input's dtype: uint8 ``[D, H, W]`` volumes
(the cohort's 8-bit voxels, cast raw to float32 per batch by the trainer)
or float32 ``[H, W, C]`` images (the vision datasets, normalized at load);
``y[C, Nmax]`` int32 and the true counts ``n[C]`` (also kept on the host
as numpy, where the Python client loop reads them). A validation split
(``X_val``, ``y_val``, ``n_val``; FedFomo's) is carved out of each
client's training rows where ``val_fraction > 0``. The test rows index the
training pool (the cohorts) or a pool of their own (``X_eval``: the vision
datasets ship separate train and test arrays).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.data import partition as P


@dataclass
class FederatedData:
    X_train: torch.Tensor   # [C, Ntr_max, D, H, W] uint8 or [.., H, W, C] f32
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


def _stack_pad(X: np.ndarray, y: np.ndarray, idx_map: dict[int, np.ndarray],
               pad: int = 0):
    C = len(idx_map)
    nmax = max(1, max(len(v) for v in idx_map.values()))
    Xs = np.zeros((C + pad, nmax) + X.shape[1:], dtype=X.dtype)
    ys = np.zeros((C + pad, nmax), dtype=np.int32)
    ns = np.zeros((C + pad,), dtype=np.int64)
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
                         val_map: dict[int, np.ndarray] | None = None,
                         X_eval: np.ndarray | None = None,
                         y_eval: np.ndarray | None = None,
                         mesh_size: int = 1) -> FederatedData:
    """Stack, pad and move the federation to ``device`` (with the
    validation rows of ``val_map``, where given). ``test_map`` indexes
    ``X_eval`` / ``y_eval`` where given, ``X`` / ``y`` otherwise. The
    client count is padded up to a multiple of ``mesh_size`` with
    zero-sample clients (their aggregation weight is always 0), as the
    reference pads to its mesh."""
    put = lambda a: torch.from_numpy(a).to(device)
    Xev = X if X_eval is None else X_eval
    yev = y if y_eval is None else y_eval
    pad = (mesh_size - len(train_map) % mesh_size) % mesh_size
    Xtr, ytr, ntr = _stack_pad(X, y, train_map, pad)
    Xte, yte, nte = _stack_pad(Xev, yev, test_map, pad)
    val = {}
    if val_map is not None:
        Xv, yv, nv = _stack_pad(X, y, val_map, pad)
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
    train_map, test_map, sites = P.site_partition(site, seed=seed)
    val_map = None
    if val_fraction > 0:
        val_map, train_map = carve_val_split(train_map, val_fraction, seed)
    info = {"partition_method": "site", "sites": sites.tolist(),
            "client_num": len(train_map),
            "train_counts": [int(len(train_map[c])) for c in sorted(train_map)]}
    return train_map, test_map, val_map, info


def federate_cohort(data: dict[str, np.ndarray], device: torch.device,
                    seed: int = 42, val_fraction: float = 0.0,
                    partition_method: str = "site",
                    client_number: int | None = None, alpha: float = 0.5,
                    mesh_size: int = 1) -> tuple[FederatedData, dict]:
    """Partition a cohort ``{X, y, site}`` into clients on ``device``,
    carving a validation split where ``val_fraction > 0``: by site, or into
    ``client_number`` clients by ``rescale`` (contiguous shards of one
    shuffle), ``dir`` / ``hetero`` (Dirichlet(``alpha``) over the labels)
    or ``homo`` (IID), the last three split 80/20 inside each client;
    the client count padded to a multiple of ``mesh_size``."""
    X, y = data["X"], data["y"]
    if partition_method == "site":
        train_map, test_map, val_map, info = federation_maps(
            data["site"], seed, val_fraction)
    else:
        if partition_method not in ("rescale", "dir", "hetero", "homo"):
            raise ValueError(
                f"unknown partition_method {partition_method!r}")
        if client_number is None:
            raise ValueError(f"partition_method {partition_method!r} needs "
                             "client_number")
        if partition_method == "rescale":
            train_map, test_map = P.rescale_partition(len(y), client_number,
                                                      seed=seed)
        else:
            idx_map = (P.homo_partition(len(y), client_number, seed=seed)
                       if partition_method == "homo" else
                       P.dirichlet_partition(y, client_number, alpha,
                                             seed=seed))
            train_map, test_map = P.train_test_split_per_client(idx_map,
                                                                seed=seed)
        val_map = None
        if val_fraction > 0:
            val_map, train_map = carve_val_split(train_map, val_fraction,
                                                 seed)
        info = {"partition_method": partition_method,
                "client_num": len(train_map),
                "train_counts": [int(len(train_map[c]))
                                 for c in sorted(train_map)]}
    info["stats"] = P.record_data_stats(y, train_map)
    fed = build_federated_data(X, y, train_map, test_map, device,
                               val_map=val_map, mesh_size=mesh_size)
    return fed, info
