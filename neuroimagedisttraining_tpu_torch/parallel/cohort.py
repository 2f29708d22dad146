"""Cohort sharding: the sampled clients of a round split over the mesh.

Each mesh entry trains its ``C/D`` consecutive clients (on its device,
on its own CUDA stream on a card) and the trained states come back to
the aggregating device in client order (:func:`cohort_map`). A sampled
set that does not tile the mesh is padded (:func:`pad_cohort`, the
reference's rule: the federation's zero-sample clients first, then the
last sampled id repeated) and :func:`pad_row_weights` is the one place
where pad rows get zero weight. A pad row trains nothing (a zero-weight
no-op: its state is the round's incoming model) and the round's tail
slices the pad rows off before the attack, the codec, the defense and
the mean, so the tail runs the same operations on the same values as the
unsharded round.

The host queues every client in client order, whichever entry trains it,
so the trainer's generator draws what the unsharded round draws: a
sharded round is bit for bit the unsharded one (the reference pins its
own sharded round only to ~1 ulp, since XLA tiles the two programs
differently; the port runs the same kernels in both).
"""

from __future__ import annotations

import numpy as np
import torch


def pad_cohort(sampled: np.ndarray, real_clients: int, num_clients: int,
               n_devices: int) -> tuple[np.ndarray, int]:
    """``(padded_ids, n_real)``: the sampled set padded to tile an
    ``n_devices``-entry mesh, with the federation's zero-sample padding
    clients (rows ``[real_clients, num_clients)``) first, then the last
    sampled id repeated."""
    sampled = np.asarray(sampled)
    if len(sampled) == 0:
        raise ValueError("pad_cohort got an empty sampled set — no client "
                         "to pad the mesh tile from (configuration error)")
    pad = (-len(sampled)) % n_devices
    if pad == 0:
        return sampled, len(sampled)
    pool = np.arange(real_clients, num_clients)
    fill = np.concatenate([pool, np.full(max(0, pad - len(pool)),
                                         sampled[-1])])[:pad]
    return np.concatenate([sampled, fill]).astype(sampled.dtype), \
        len(sampled)


def pad_row_weights(ns: torch.Tensor, n_real: int) -> torch.Tensor:
    """The per-client sample counts with the pad rows' (index >=
    ``n_real``) zeroed: a pad entry may repeat a real client id, so the
    position, not the id, makes it a zero-weight row."""
    return torch.where(torch.arange(ns.shape[0], device=ns.device) < n_real,
                       ns, torch.zeros_like(ns))


def sequential_map(fn, items: list) -> list:
    """``fn`` of each client's item, one client after another."""
    return [fn(x) for x in items]


def _to(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device, non_blocking=True)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def cohort_map(mesh, fn, items: list, device: torch.device) -> list:
    """``fn`` of each client's item with the clients cut into the mesh's
    consecutive blocks: entry ``d`` runs its block on its device and
    stream; the results come back to ``device`` in client order. The
    client count must tile the mesh (:func:`pad_cohort`)."""
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"cohort_map shards over a 1-D client mesh; got axes "
            f"{mesh.axis_names} (two-level meshes route aggregation "
            "silo-first instead — parallel/hierarchical.py)")
    D = mesh.devices.size
    C = len(items)
    if C % D != 0:
        raise ValueError(
            f"cohort_map: client axis ({C}) does not tile the {D}-device "
            "mesh — pad the sampled set with pad_cohort first")
    B = C // D
    cur = (torch.cuda.current_stream(device) if device.type == "cuda"
           else None)
    out = []
    for d, dev in enumerate(mesh.entries):
        s = mesh.streams[d]
        if s is not None:  # the inputs were made on the caller's stream
            s.wait_stream(torch.cuda.current_stream(s.device))
        with mesh.stream(d):
            for x in items[d * B:(d + 1) * B]:
                out.append(fn(_to(x, dev)))
    for s in mesh.streams:
        if s is not None and cur is not None:
            cur.wait_stream(s)
    return [_to(o, device) for o in out]
