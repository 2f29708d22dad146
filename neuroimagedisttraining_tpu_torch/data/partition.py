"""Client partitioners, numpy ``RandomState`` draws (so the index maps are
bit-equal to the reference package's):

- ``site_partition``: one client per acquisition site, each site split
  80/20 into train/test after a ``RandomState(seed)`` shuffle (the
  reference's per-site split, re-seeded for every site).
- ``rescale_partition``: one global shuffle, an 80/20 split, then
  contiguous equal shards per client (the cross-silo scale-out path).
- ``dirichlet_partition``: the LDA non-IID partitioner, with its retry
  until every client holds at least ``min_size_floor`` rows and the
  capacity correction that zeroes the prior of a client already at its
  ``n / clients`` quota.
- ``homo_partition``: an IID equal random split.
- ``train_test_split_per_client``: the 80/20 split inside each client's
  shard (for the non-site partitions).
- ``record_data_stats``: each client's ``{class: count}`` census.
"""

from __future__ import annotations

import numpy as np


def site_partition(site: np.ndarray, seed: int = 42, test_frac: float = 0.2
                   ) -> tuple[dict[int, np.ndarray], dict[int, np.ndarray], np.ndarray]:
    """Returns (train_idx_by_client, test_idx_by_client, site_values)."""
    unique_sites = np.unique(site)
    train_map, test_map = {}, {}
    for client, s in enumerate(unique_sites):
        idx = np.where(site == s)[0]
        n_test = int(len(idx) * test_frac)
        n_train = len(idx) - n_test
        rs = np.random.RandomState(seed)
        rs.shuffle(idx)
        train_map[client] = idx[:n_train]
        test_map[client] = idx[n_train:]
    return train_map, test_map, unique_sites


def rescale_partition(n: int, client_number: int, seed: int = 42,
                      test_frac: float = 0.2
                      ) -> tuple[dict[int, np.ndarray], dict[int, np.ndarray]]:
    """``(train_map, test_map)``: ``arange(n)`` shuffled once, its last
    ``int(n * test_frac)`` rows the test pool, each pool cut into
    ``client_number`` contiguous shards, each shard sorted."""
    idx = np.arange(n)
    rs = np.random.RandomState(seed)
    rs.shuffle(idx)
    n_test = int(n * test_frac)
    train_idx, test_idx = idx[: n - n_test], idx[n - n_test:]
    train_map = {c: np.sort(a) for c, a in
                 enumerate(np.array_split(train_idx, client_number))}
    test_map = {c: np.sort(a) for c, a in
                enumerate(np.array_split(test_idx, client_number))}
    return train_map, test_map


def dirichlet_partition(labels: np.ndarray, client_number: int, alpha: float,
                        seed: int = 0, min_size_floor: int = 10
                        ) -> dict[int, np.ndarray]:
    """Each class's rows, shuffled, cut among the clients by a
    Dirichlet(``alpha``) draw (zero for a client at its quota); the whole
    draw repeats until every client holds ``min_size_floor`` rows."""
    rs = np.random.RandomState(seed)
    n = len(labels)
    classes = np.unique(labels)
    min_size = 0
    idx_batch: list[list[int]] = [[] for _ in range(client_number)]
    while min_size < min_size_floor:
        idx_batch = [[] for _ in range(client_number)]
        for k in classes:
            idx_k = np.where(labels == k)[0]
            rs.shuffle(idx_k)
            p = rs.dirichlet(np.repeat(alpha, client_number))
            p = np.array([pi * (len(ib) < n / client_number)
                          for pi, ib in zip(p, idx_batch)])
            p = p / p.sum()
            cuts = (np.cumsum(p) * len(idx_k)).astype(int)[:-1]
            idx_batch = [ib + part.tolist()
                         for ib, part in zip(idx_batch, np.split(idx_k, cuts))]
        min_size = min(len(ib) for ib in idx_batch)
    return {c: np.array(sorted(ib), dtype=np.int64)
            for c, ib in enumerate(idx_batch)}


def homo_partition(n: int, client_number: int, seed: int = 0
                   ) -> dict[int, np.ndarray]:
    """A random permutation of ``n`` rows cut into equal sorted shards."""
    rs = np.random.RandomState(seed)
    idx = rs.permutation(n)
    return {c: np.sort(a) for c, a in
            enumerate(np.array_split(idx, client_number))}


def train_test_split_per_client(idx_map: dict[int, np.ndarray], seed: int = 42,
                                test_frac: float = 0.2
                                ) -> tuple[dict[int, np.ndarray], dict[int, np.ndarray]]:
    """Each client's shard shuffled by a fresh ``RandomState(seed)``, its
    last ``int(n * test_frac)`` rows held out for testing."""
    train_map, test_map = {}, {}
    for c, idx in idx_map.items():
        idx = np.array(idx, copy=True)
        rs = np.random.RandomState(seed)
        rs.shuffle(idx)
        n_test = int(len(idx) * test_frac)
        train_map[c] = idx[: len(idx) - n_test]
        test_map[c] = idx[len(idx) - n_test:]
    return train_map, test_map


def record_data_stats(labels: np.ndarray, idx_map: dict[int, np.ndarray]
                      ) -> dict[int, dict[int, int]]:
    """Each client's ``{class: count}``."""
    stats = {}
    for c, idx in idx_map.items():
        uniq, counts = np.unique(labels[idx], return_counts=True)
        stats[c] = {int(u): int(cnt) for u, cnt in zip(uniq, counts)}
    return stats
