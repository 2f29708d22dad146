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

On a mesh that spans ranks (``parallel/mesh.py``) each rank trains only
its own entries' clients, and the ranks take their turns in rank order,
which is client order: a rank starts its clients from the generator
state the rank before it ended with, so every client draws what it draws
in one process (:func:`exchange` hands the state on with the trained
states). Every rank receives every other rank's trained states in client
order, runs the same round tail on the same values and ends the round
with the same model and generator state. The exchange is staged through
host memory: a rank's results are packed into one byte buffer, copied to
the host and sent with gloo's ``broadcast`` (its layout and the
generator's state first, as a ``broadcast_object_list``); a receiver
copies the buffer to its device once.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

log = logging.getLogger(__name__)


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


def _run_entries(mesh, fn, items: list, B: int, device: torch.device,
                 out: list) -> None:
    """``fn`` of the items of this process's entries, each entry's block on
    its device and stream, into ``out`` on ``device``."""
    cur = (torch.cuda.current_stream(device) if device.type == "cuda"
           else None)
    mine = []
    for d in mesh.local_entries:
        dev = mesh.entries[d]
        s = mesh.streams[d]
        if s is not None:  # the inputs were made on the caller's stream
            s.wait_stream(torch.cuda.current_stream(s.device))
        with mesh.stream(d):
            for j in range(d * B, (d + 1) * B):
                out[j] = fn(_to(items[j], dev))
                mine.append(j)
    for s in mesh.streams:
        if s is not None and cur is not None:
            cur.wait_stream(s)
    for j in mine:
        out[j] = _to(out[j], device)


def cohort_map(mesh, fn, items: list, device: torch.device,
               generator: torch.Generator | None = None) -> list:
    """``fn`` of each client's item with the clients cut into the mesh's
    consecutive blocks: entry ``d`` runs its block on its device and
    stream; the results come back to ``device`` in client order. The
    client count must tile the mesh (:func:`pad_cohort`). On a mesh that
    spans ranks the ranks take turns in rank order: each runs its own
    entries' blocks from ``generator``'s state as the rank before it left
    it, and hands its results and that state on (:func:`exchange`)."""
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
    out = [None] * C
    if mesh.num_processes == 1:
        _run_entries(mesh, fn, items, B, device, out)
        return out
    owners = np.repeat(mesh.ranks, B)
    for r in range(mesh.num_processes):
        if r == mesh.process_id:
            _run_entries(mesh, fn, items, B, device, out)
        out = exchange(out, owners, r, mesh.process_id, device, generator)
    return out


class _Leaf:
    """Where a packed tensor sits in its rank's byte buffer."""

    def __init__(self, offset: int, nbytes: int, shape, dtype):
        self.offset, self.nbytes = offset, nbytes
        self.shape, self.dtype = tuple(shape), dtype


_ALIGN = 16


def _pack(tree) -> tuple[object, list[torch.Tensor], int]:
    """``(layout, byte views, nbytes)``: ``tree`` with each tensor replaced
    by its :class:`_Leaf` in a buffer of the tensors' bytes, each at a
    16-byte aligned offset."""
    parts: list[torch.Tensor] = []
    size = 0

    def walk(x):
        nonlocal size
        if isinstance(x, torch.Tensor):
            b = x.detach().reshape(-1).view(torch.uint8)
            leaf = _Leaf(size, b.numel(), x.shape, x.dtype)
            pad = (-b.numel()) % _ALIGN
            parts.append(b)
            if pad:
                parts.append(b.new_zeros(pad))
            size += b.numel() + pad
            return leaf
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return x

    return walk(tree), parts, size


def _unpack(layout, buf: torch.Tensor):
    """The tree of a :func:`_pack` layout over the byte buffer ``buf``:
    each tensor a view of it."""
    if isinstance(layout, _Leaf):
        return buf[layout.offset:layout.offset + layout.nbytes].view(
            layout.dtype).view(layout.shape)
    if isinstance(layout, dict):
        return {k: _unpack(v, buf) for k, v in layout.items()}
    if isinstance(layout, tuple) and hasattr(layout, "_fields"):
        return type(layout)(*(_unpack(v, buf) for v in layout))
    if isinstance(layout, (list, tuple)):
        return type(layout)(_unpack(v, buf) for v in layout)
    return layout


def exchange(results: list, owners, src: int, process_id: int,
             device: torch.device,
             generator: torch.Generator | None = None) -> list:
    """Rank ``src``'s turn of handing its results on: entry ``j`` of
    ``results`` is rank ``owners[j]``'s; rank ``src`` packs its entries
    into one byte buffer on the host and broadcasts its layout and
    ``generator``'s state (``broadcast_object_list``), then the buffer
    (``broadcast``); every other rank takes that generator state and
    copies the buffer to ``device`` once, each received tensor a view of
    the copy. The layout carries the results' structure and any value
    that is not a tensor. A receiver's wait for the layout (``src``'s
    training) and the transfer after it are logged apart."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    idx = np.flatnonzero(np.asarray(owners) == src).tolist()
    out = list(results)
    if src == process_id:
        layout, parts, size = _pack([results[j] for j in idx])
        state = generator.get_state() if generator is not None else None
        dist.broadcast_object_list([layout, size, state], src=src)
        t1 = time.perf_counter()
        buf = (torch.cat(parts).cpu() if parts
               else torch.empty(0, dtype=torch.uint8))
    else:
        head = [None, None, None]
        dist.broadcast_object_list(head, src=src)
        t1 = time.perf_counter()
        layout, size, state = head
        if generator is not None:
            generator.set_state(state)
        buf = torch.empty(size, dtype=torch.uint8)
    if size:
        dist.broadcast(buf, src=src)
    if src != process_id:
        for j, o in zip(idx, _unpack(layout, buf.to(device))):
            out[j] = o
    log.info("exchange: %d bytes from rank %d in %.3f ms after a %.3f ms "
             "wait", size, src, (time.perf_counter() - t1) * 1e3,
             (t1 - t0) * 1e3)
    return out
