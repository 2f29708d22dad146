"""Site partitioner: one client per acquisition site, each site split
80/20 into train/test after a ``RandomState(seed)`` shuffle (the
reference's per-site split, re-seeded for every site)."""

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
