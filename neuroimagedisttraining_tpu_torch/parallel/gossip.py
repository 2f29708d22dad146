"""Sparse gossip consensus over the mesh (the reference package's
``parallel/gossip.py``).

The decentralized engines' consensus is ``einsum("cj,j...->c...", M, x)``
over the stacked client models. Two sparse forms replace it where the
round's mixing matrix allows, with plans equal to the reference's (host
numpy):

1. CIRCULANT (:func:`circulant_plan`, :func:`gossip_apply`): the ring and
   k-lattice topologies give ``M[c, j] = base[(j - c) mod C]``, so the
   consensus is a few weighted rotations of the client axis; each mesh
   entry builds its rows of a rotation from its own block and ``|k|``
   rows copied from its neighbour's.
2. GENERAL SPARSE (:func:`sparse_plan`, :func:`gossip_apply_sparse`):
   per-round random topologies route, per ordered pair of entries, only
   the rows the destination's clients read (padded to a slot count
   ``m``), and each entry gathers its clients' neighbour rows from what it
   received and its own block.

Both sum in float32 in a fixed order and agree with the einsum to float32
rounding; :func:`make_plan` picks circulant, then sparse, else the dense
einsum (``(None, {})``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.parallel.mesh import CLIENT_AXIS

#: plan entry: (signed client-axis offset, mixing weight)
Plan = tuple[tuple[int, float], ...]


def circulant_plan(M: np.ndarray, tol: float = 0.0) -> Plan | None:
    """``((offset, weight), ...)`` when ``M`` is circulant, else None.

    Offsets are signed (shortest direction around the ring) and sorted, so
    equal matrices always produce the same (hashable) plan — engines key
    their jit caches on it."""
    M = np.asarray(M)
    C = M.shape[0]
    if M.ndim != 2 or M.shape[1] != C or C == 0:
        return None
    base = M[0]
    for i in range(1, C):
        if not (np.abs(M[i] - np.roll(base, i)) <= tol).all():
            return None
    plan = []
    for j in np.flatnonzero(base):
        k = int(j) if j <= C // 2 else int(j) - C
        plan.append((k, float(base[j])))
    return tuple(sorted(plan))


def plan_fits_mesh(plan: Plan, mesh, num_clients: int) -> bool:
    """A plan runs as single-hop shifts iff the mesh is the 1-D
    client mesh, the client axis tiles it, and every offset stays within
    one entry's block."""
    if mesh is None or plan is None:
        return False
    if tuple(mesh.axis_names) != (CLIENT_AXIS,):
        return False
    D = mesh.devices.size
    if D < 2 or num_clients % D != 0:
        return False
    block = num_clients // D
    return all(abs(k) <= block for k, _ in plan)


def make_plan(M: np.ndarray, mesh, num_clients: int):
    """``(plan, plan_arrays)`` for a round's mixing/adjacency matrix — the
    shared circulant -> sparse -> dense cascade used by the decentralized
    engines: a hashable circulant Plan tuple (ring shifts) when the
    matrix is circulant and tiles the mesh, a SparseSpec + traced routing
    arrays (the routed exchange) for sparse patterns, else ``(None, {})``
    for the dense einsum."""
    plan = circulant_plan(M)
    if plan_fits_mesh(plan, mesh, num_clients):
        return plan, {}
    sp = sparse_plan(M, mesh, num_clients)
    if sp is not None:
        return sp
    return None, {}


# ---------- general sparse (per-round random) topologies ----------


@dataclasses.dataclass(frozen=True)
class SparseSpec:
    """Static (hashable) part of a sparse gossip plan.

    ``m`` is bucketed to quarters of B (the reference's rule, which keeps
    its compiled programs few while the random topology changes every
    round); ``n_max``
    is the per-round max row support, which is constant for a fixed
    (k, activity) config."""
    D: int       # devices on the 1-D client mesh
    B: int       # clients per device (C // D)
    m: int       # padded per-(src, dst) slot count of the exchange
    n_max: int   # padded per-client neighbor count for the local gather


def _bucket(n: int, q: int) -> int:
    """Round n up to the next multiple of q (n >= 1)."""
    n = max(n, 1)
    return ((n + q - 1) // q) * q


def sparse_plan(M: np.ndarray, mesh, num_clients: int
                ) -> tuple[SparseSpec, dict[str, np.ndarray]] | None:
    """Routing plan for an arbitrary sparse mixing matrix on the 1-D
    client mesh, or None when the einsum is no worse (pattern dense
    enough that some device pair would exchange its full block).

    Returns ``(spec, arrays)``:
    - ``arrays["send_idx"]`` [D, D, m] int32 — device s's slot for
      destination d holds LOCAL row indices (deduplicated, ascending),
      padded with 0 (padding rows are sent but never gathered).
    - ``arrays["gather_idx"]`` [C, n_max] int32 — per client, positions
      into the receiver's pool = concat(received rows [D*m], local
      block [B]), neighbor terms in ascending global-j order (matching
      the einsum's reduction order), padded with 0.
    - ``arrays["gather_w"]`` [C, n_max] float32 — matching weights,
      padding 0.
    """
    M = np.asarray(M)
    C = M.shape[0]
    if M.ndim != 2 or M.shape[1] != C or C == 0:
        return None
    if mesh is None or tuple(mesh.axis_names) != (CLIENT_AXIS,):
        return None
    D = mesh.devices.size
    if D < 2 or num_clients % D != 0 or C != num_clients:
        return None
    B = C // D

    rows = [np.flatnonzero(M[c]) for c in range(C)]
    n_actual = max((len(r) for r in rows), default=0)
    # send sets: per ordered device pair (s != d), the deduplicated local
    # rows of s referenced by any client of d
    need: list[list[set]] = [[set() for _ in range(D)] for _ in range(D)]
    for c in range(C):
        d = c // B
        for j in rows[c]:
            s = int(j) // B
            if s != d:
                need[s][d].add(int(j) - s * B)
    m_actual = max((len(need[s][d]) for s in range(D) for d in range(D)),
                   default=0)
    # bucket to quarters of B (bounded program count per config); the plan
    # only pays off when the padded per-pair slots stay strictly below a
    # full block — at m == B the exchange moves the all-gather volume
    # (that covers B == 1 too: one-client-per-device random gossip has no
    # sparse win, every row is a full block)
    m = _bucket(m_actual, max(1, B // 4))
    if m >= B:
        return None
    n_max = min(max(n_actual, 1), C)

    send_idx = np.zeros((D, D, m), np.int32)
    slot: dict[tuple[int, int, int], int] = {}
    for s in range(D):
        for d in range(D):
            for i, r in enumerate(sorted(need[s][d])):
                send_idx[s, d, i] = r
                slot[(s, d, r)] = i
    gather_idx = np.zeros((C, n_max), np.int32)
    gather_w = np.zeros((C, n_max), np.float32)
    for c in range(C):
        d = c // B
        for i, j in enumerate(rows[c]):  # ascending j == einsum order
            s = int(j) // B
            if s == d:
                gather_idx[c, i] = D * m + (int(j) - d * B)
            else:
                gather_idx[c, i] = s * m + slot[(s, d, int(j) - s * B)]
            gather_w[c, i] = M[c, j]
    spec = SparseSpec(D=D, B=B, m=m, n_max=n_max)
    return spec, {"send_idx": send_idx, "gather_idx": gather_idx,
                  "gather_w": gather_w}


# ---------- the consensus over the mesh's entries ----------


def _blocks(x: torch.Tensor, mesh) -> list[torch.Tensor]:
    """``x``'s consecutive client blocks, each on its entry's device, in
    float32."""
    D = mesh.devices.size
    B = x.shape[0] // D
    return [x[d * B:(d + 1) * B].to(dev, torch.float32)
            for d, dev in enumerate(mesh.entries)]


def _rolled(blocks: list[torch.Tensor], d: int, k: int) -> torch.Tensor:
    """Entry ``d``'s rows of the rotation ``rolled[i] = x[(i + k) mod C]``:
    its own rows and ``|k|`` rows copied from the next (``k > 0``) or the
    previous entry."""
    blk = blocks[d]
    if k == 0:
        return blk
    D, B = len(blocks), blk.shape[0]
    if k > 0:
        recv = blocks[(d + 1) % D][:k].to(blk.device)
        return torch.cat([blk[k:], recv], 0)
    kk = -k
    recv = blocks[(d - 1) % D][B - kk:].to(blk.device)
    return torch.cat([recv, blk[:B - kk]], 0)


def gossip_apply(tree: dict, plan: Plan, mesh) -> dict:
    """Circulant consensus of each stacked leaf of ``tree`` (``[C, ...]``)
    by ring shifts over the mesh: the einsum of the matrix ``plan`` came
    from, summed in float32 in the plan's order and cast back."""
    if plan is None:
        raise ValueError(
            "gossip_apply(plan=None): None means 'not circulant, use the "
            "dense einsum path'; only an actual Plan tuple is accepted")
    if not tree:
        return tree
    if plan == ():
        return {k: torch.zeros_like(v) for k, v in tree.items()}
    out = {}
    for name, x in tree.items():
        blocks = _blocks(x, mesh)
        rows = []
        for d in range(len(blocks)):
            acc = None
            for k, w in plan:
                term = w * _rolled(blocks, d, k)
                acc = term if acc is None else acc + term
            rows.append(acc.to(x.device))
        out[name] = torch.cat(rows, 0).to(x.dtype)
    return out


def gossip_apply_sparse(tree: dict, spec: SparseSpec, arrays, mesh) -> dict:
    """Sparse consensus of each stacked leaf of ``tree`` by the routed
    plan of :func:`sparse_plan`: entry ``s`` sends entry ``d`` the rows of
    ``send_idx[s, d]``; entry ``d`` gathers each client's neighbour rows
    from what it received and its own block and sums them weighted, in
    float32 in ascending neighbour order."""
    if not tree:
        return tree
    D, B, m, n_max = spec.D, spec.B, spec.m, spec.n_max
    send = torch.as_tensor(np.asarray(arrays["send_idx"]), dtype=torch.long)
    gidx = torch.as_tensor(np.asarray(arrays["gather_idx"]),
                           dtype=torch.long)
    gw = torch.as_tensor(np.asarray(arrays["gather_w"]), dtype=torch.float32)
    out = {}
    for name, x in tree.items():
        blocks = _blocks(x, mesh)
        rows = []
        for d, blk in enumerate(blocks):
            dev = blk.device
            recv = torch.cat([blocks[s][send[s, d].to(blocks[s].device)
                                        ].to(dev) for s in range(D)], 0)
            pool = torch.cat([recv, blk], 0)
            G = pool[gidx[d * B:(d + 1) * B].to(dev)]       # [B, n_max, ...]
            w = gw[d * B:(d + 1) * B].to(dev).reshape(
                (B, n_max) + (1,) * (blk.dim() - 1))
            rows.append(torch.sum(w * G, dim=1).to(x.device))
        out[name] = torch.cat(rows, 0).to(x.dtype)
    return out
