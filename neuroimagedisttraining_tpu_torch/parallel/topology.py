"""Decentralized-FL topology managers: mixing-weight matrices for gossip.

Semantics ported from fedml_core/distributed/topology/
symmetric_topology_manager.py:21-52 and asymmetric_topology_manager.py:23-75:
a ring lattice (Watts-Strogatz with rewiring p=0) unioned with a k-neighbor
lattice, self-loops added, rows normalized by degree. Implemented directly in
numpy (no networkx): WS(p=0) is a circulant ring lattice, each node linked to
``k//2`` nearest neighbors per side.

The port's copy of the reference package's ``parallel/topology.py``, bit
for bit. One consensus step over the clients is ``einsum("ij,j...->i...",
W, params)``, or the ring shifts of ``parallel/gossip.py``.
"""

from __future__ import annotations

import numpy as np


def ring_lattice(n: int, k: int) -> np.ndarray:
    """Adjacency of a circulant lattice: node i ~ i±1..i±(k//2) (mod n)."""
    adj = np.zeros((n, n), dtype=np.float32)
    half = max(1, k // 2) if n > 1 else 0
    for off in range(1, half + 1):
        for i in range(n):
            adj[i, (i + off) % n] = 1.0
            adj[i, (i - off) % n] = 1.0
    return adj


class BaseTopologyManager:
    """Interface parity with base_topology_manager.py:4-24."""

    topology: np.ndarray

    def generate_topology(self):
        raise NotImplementedError

    def get_in_neighbor_weights(self, node_index: int):
        return self.topology[:, node_index]

    def get_out_neighbor_weights(self, node_index: int):
        return self.topology[node_index]

    def get_in_neighbor_idx_list(self, node_index: int) -> list[int]:
        w = np.asarray(self.get_in_neighbor_weights(node_index))
        return [i for i in range(len(w)) if w[i] > 0 and i != node_index]

    def get_out_neighbor_idx_list(self, node_index: int) -> list[int]:
        w = np.asarray(self.get_out_neighbor_weights(node_index))
        return [i for i in range(len(w)) if w[i] > 0 and i != node_index]

    def mixing_matrix(self) -> np.ndarray:
        return self.topology


class SymmetricTopologyManager(BaseTopologyManager):
    """Ring ∪ k-lattice, self-loops, row-normalized (doubly stochastic for
    these symmetric circulants). Parity: symmetric_topology_manager.py:16-52."""

    def __init__(self, n: int, neighbor_num: int = 2):
        self.n = n
        self.neighbor_num = neighbor_num
        self.topology = np.zeros((n, n), np.float32)

    def generate_topology(self):
        adj = ring_lattice(self.n, 2)
        adj = np.maximum(adj, ring_lattice(self.n, int(self.neighbor_num)))
        np.fill_diagonal(adj, 1.0)
        self.topology = adj / adj.sum(axis=1, keepdims=True)
        return self.topology


class AsymmetricTopologyManager(BaseTopologyManager):
    """Symmetric base graph plus randomly added directed links, rows
    normalized. Parity: asymmetric_topology_manager.py:17-75 (including its
    use of the global numpy RNG for link selection — pass ``rng`` for
    reproducibility instead)."""

    def __init__(self, n: int, undirected_neighbor_num: int = 3,
                 out_directed_neighbor: int = 3, rng: np.random.Generator | None = None):
        self.n = n
        self.undirected_neighbor_num = undirected_neighbor_num
        self.out_directed_neighbor = out_directed_neighbor
        # the reference draws links from an unseeded stream; pass ``rng``
        # for reproducible topologies
        self._rng = rng or np.random.default_rng()
        self.topology = np.zeros((n, n), np.float32)

    def generate_topology(self):
        adj = ring_lattice(self.n, 2)
        adj = np.maximum(adj, ring_lattice(self.n, self.undirected_neighbor_num))
        np.fill_diagonal(adj, 1.0)
        # Randomly promote ~half of the remaining zero entries to directed
        # links, skipping entries whose reverse was already added
        # (asymmetric_topology_manager.py:45-61).
        added = set()
        for i in range(self.n):
            zeros = np.where(adj[i] == 0)[0]
            picks = self._rng.integers(0, 2, size=len(zeros))
            for j, p in zip(zeros, picks):
                if p == 1 and (j * self.n + i) not in added:
                    adj[i, j] = 1.0
                    added.add(i * self.n + j)
        self.topology = adj / adj.sum(axis=1, keepdims=True)
        return self.topology


def ring_mixing_matrix(n: int) -> np.ndarray:
    """Plain ring consensus weights (each row: self + 2 neighbors, 1/3)."""
    adj = ring_lattice(n, 2)
    np.fill_diagonal(adj, 1.0)
    return adj / adj.sum(axis=1, keepdims=True)


def full_mixing_matrix(n: int) -> np.ndarray:
    return np.full((n, n), 1.0 / n, dtype=np.float32)
