"""The streamed federation: client rows fed to the card a chunk at a time
from a lazy host source, for cohorts too large to keep on the device.

The real ABCD cohort (11,573 subjects of 121x145x121 uint8, 24.5 GB) need
not fit on the card: the voxels stay in the source (an open HDF5 dataset
or a row-sliceable ndarray such as a memmap), and only the clients the
engine is about to read are gathered and copied over. The port of the
reference package's ``data/stream.py:47-353``, with its surface and its
bytes: ``prefetch_train`` / ``get_train``, ``prefetch_window`` /
``get_window`` (a dispatch window's rounds as one fetch), ``eval_chunks``,
``get_val_resident``, ``transfer_stats``, ``sync`` and ``close``.

Every buffer holds the bytes of the resident ``_stack_pad``
(``data/federate.py``) in its order: ``X[S, nmax, ...]`` with zero rows
past each client's count, ``y[S, nmax]`` int32 with zero padding and the
true counts ``n[S]``; ``nmax`` is the split's largest client over the
whole federation, so every chunk has one shape.

The feed, designed for the card and the engines' client-by-client loop:

- Two staging slots alternate. Each holds a host slab (pinned where the
  feed's device is CUDA) and a device slab, allocated at first use and
  grown only when a larger fetch comes; the native gather
  (``utils/native.py``) writes straight into the host slab.
- Only each client's own rows cross to the card. The device slab starts
  at zero, and a slot remembers which of its rows hold a client's data:
  rows that held data and now are padding are zeroed on the card, so the
  padding (most of a chunk where one site is large) is neither written
  on the host nor copied.
- One reader thread gathers a chunk and copies it with ``non_blocking``
  copies on a copy stream of its own, then records an event there. It
  waits on that event (as the reference's ``block_until_ready``) before
  the fetch counts as done; ``device_put_ms`` is the copy's device time
  from CUDA events on the copy stream.
- The consumer's stream waits on that event (``wait_event``) when the
  chunk is served; nothing synchronizes the main thread with the card.
  When the next chunk is served, an event recorded on the consumer's
  stream releases the slot, and the copy stream waits on it before it
  writes the slot again. So chunk k+1's gather and copy ride behind chunk
  k's compute, and the feed holds two chunks on the card.
- A served chunk's tensors stay valid until the next fetch is served.
  One fetch at most is in flight unserved (a prefetch, or a walk's next
  chunk): walks do not interleave, and one that finds its next chunk
  replaced raises.

On a CPU device (the tests) the slabs are ordinary tensors, the copy is a
plain ``copy_`` and no event is used. Pinning follows the ``device`` the
caller gives, never a probe for a card.

A window of ``--rounds_per_dispatch K`` rounds (``engines/program.py``)
reads its K rounds' training rows as one fetch, ``[K, S, nmax, ...]``
(``get_window``), and ``prefetch_window`` starts the next window's behind
the current compute, through the same two slots (a slot then holds K
rounds' rows).

Left out of the port: the mesh sharding of the reference's ``_put`` (a
streamed run under ``--client_mesh`` runs unsharded with the reference's
``streaming-sharded-feed`` reason) and the ``nidt_stream_transfer``
gauge, which goes with its ``obs/``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Iterator, NamedTuple

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.data.hdf5 import fetch_rows
from neuroimagedisttraining_tpu_torch.utils import native


class EvalChunk(NamedTuple):
    """One streamed client chunk: ``ids`` the real client ids,
    ``padded_ids`` those repeated at the last id up to the chunk size; the
    tensors are always chunk-sized, the pad clients zero with ``n`` 0."""

    ids: np.ndarray
    padded_ids: np.ndarray
    X: torch.Tensor
    y: torch.Tensor
    n: torch.Tensor


class _Slot:
    """A host slab and a device slab of ``rows`` voxel rows each (and
    their int32 part: ``y`` then ``n``), with the events that order their
    reuse: ``copied`` after the slot's last copy, ``released`` when the
    consumer let go of it."""

    def __init__(self, cuda: bool):
        self.rows = 0
        self.host_X = self.dev_X = self.host_i = self.dev_i = None
        #: [rows] the device slab's rows that hold data (the rest are 0)
        self.data_rows = np.zeros(0, bool)
        self.copied = torch.cuda.Event() if cuda else None
        self.released = torch.cuda.Event() if cuda else None


class StreamingFederation:
    """A chunk-granular host-to-device feed over a lazy voxel source.

    ``X_source``: an ``h5py`` dataset or an ndarray (a memmap, say), read
    by rows. ``y``: the labels (on the host). ``train_map`` / ``test_map``
    / ``val_map``: each client's rows (``data/federate.py``
    ``federation_maps``). ``device``: where the chunks go.
    """

    def __init__(self, X_source, y: np.ndarray,
                 train_map: dict[int, np.ndarray],
                 test_map: dict[int, np.ndarray],
                 val_map: dict[int, np.ndarray] | None = None,
                 device: str | torch.device = "cuda"):
        self.X = X_source
        self.y = np.asarray(y)
        self.device = torch.device(device)
        self.train_map = {c: np.asarray(v) for c, v in train_map.items()}
        self.test_map = {c: np.asarray(v) for c, v in test_map.items()}
        self.val_map = (None if val_map is None else
                        {c: np.asarray(v) for c, v in val_map.items()})
        self.num_clients = len(train_map)
        count = lambda m: np.array([len(m[c]) for c in range(
            self.num_clients)], np.int32)
        self.n_train, self.n_test = count(self.train_map), count(self.test_map)
        self.nmax_train = max(1, int(self.n_train.max()))
        self.nmax_test = max(1, int(self.n_test.max()))
        if self.val_map is not None:
            self.n_val = count(self.val_map)
            self.nmax_val = max(1, int(self.n_val.max()))
        self.sample_shape = tuple(self.X.shape[1:])
        self.dtype = np.dtype(self.X.dtype)
        self._torch_dtype = torch.from_numpy(np.empty(0, self.dtype)).dtype
        self._cuda = self.device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(self.device) if self._cuda
                             else None)
        self._slots = [_Slot(self._cuda), _Slot(self._cuda)]
        self._served: int | None = None
        self._pending: tuple[tuple, Future] | None = None
        self._pool = ThreadPoolExecutor(max_workers=1)
        #: the reader thread's totals: gather and copy times (ms), bytes
        #: copied to the device (the clients' rows, and the int32 labels
        #: and counts whole) and fetches made
        self.transfer_stats = {"host_gather_ms": 0.0, "device_put_ms": 0.0,
                               "bytes": 0.0, "fetches": 0}
        #: the main thread's total time waiting for fetches (ms), and the
        #: part of it after which the consumer's stream had run dry (an
        #: upper bound on the card's idle time the feed caused; CUDA only)
        self.wait_ms = 0.0
        self.idle_wait_ms = 0.0
        self._stats_lock = threading.Lock()

    # ---------- rows (reader thread) ----------

    def _split_maps(self, split: str):
        if split == "train":
            return self.train_map, self.nmax_train
        if split == "test":
            return self.test_map, self.nmax_test
        if split == "val":
            if self.val_map is None:
                raise ValueError("this StreamingFederation was built "
                                 "without a val_map (val_fraction=0)")
            return self.val_map, self.nmax_val
        raise ValueError(f"unknown split {split!r}")

    def _fill(self, Xs: np.ndarray, ys: np.ndarray, ns: np.ndarray,
              client_ids, split: str, n_real: int | None) -> None:
        """Fill ``[S, nmax, ...]`` buffers: each client's rows in ``Xs``
        (rows past its count are left as they are), its labels in ``ys``
        then zeros up to ``nmax``, its count in ``ns``; entries from
        ``n_real`` on are pad clients, with no rows."""
        idx_map, _ = self._split_maps(split)
        for j, c in enumerate(client_ids):
            idx = (idx_map[int(c)] if n_real is None or j < n_real
                   else idx_map[int(c)][:0])
            k = len(idx)
            if k:
                if isinstance(self.X, np.ndarray):
                    native.gather_rows(self.X, idx, out=Xs[j])
                else:
                    Xs[j, :k] = fetch_rows(self.X, idx)
                ys[j, :k] = self.y[idx]
            ys[j, k:] = 0
            ns[j] = k

    def _fetch(self, client_ids, split: str, n_real: int | None = None):
        """Fresh host arrays ``(X, y, n)`` for ``client_ids``, zero past
        each client's rows."""
        _, nmax = self._split_maps(split)
        S = len(client_ids)
        Xs = np.zeros((S, nmax) + self.sample_shape, self.dtype)
        ys = np.zeros((S, nmax), np.int32)
        ns = np.zeros((S,), np.int32)
        self._fill(Xs, ys, ns, client_ids, split, n_real)
        return Xs, ys, ns

    def _grow(self, slot: _Slot, rows: int) -> None:
        """Slabs of at least ``rows`` voxel rows for ``slot``."""
        if slot.rows >= rows:
            return
        if self._cuda:
            # queued work on the consumer's stream may still read the old
            # slabs: they are freed only once it is done with them
            slot.released.synchronize()
        shape = (rows,) + self.sample_shape
        pin = self._cuda
        slot.host_X = torch.empty(shape, dtype=self._torch_dtype,
                                  pin_memory=pin)
        slot.host_i = torch.empty(2 * rows, dtype=torch.int32, pin_memory=pin)
        slot.dev_X = torch.zeros(shape, dtype=self._torch_dtype,
                                 device=self.device)
        slot.dev_i = torch.empty(2 * rows, dtype=torch.int32,
                                 device=self.device)
        if self._cuda:
            # the new device slabs may reuse memory that queued work on the
            # consumer's stream still reads: the copies wait for it
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            self._copy_stream.wait_event(ready)
        slot.rows = rows
        slot.data_rows = np.zeros(rows, bool)

    def _fetch_put(self, client_ids: np.ndarray, split: str,
                   n_real: int | None, slot_i: int):
        """The reader thread's unit of work: gather ``client_ids``' rows
        into slot ``slot_i``'s host slab and copy them to its device slab.
        Returns the chunk's ``(X, y, n, slot_i)`` on the device."""
        _, nmax = self._split_maps(split)
        S = len(client_ids)
        rows = S * nmax
        slot = self._slots[slot_i]
        with (torch.cuda.device(self.device) if self._cuda
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            self._grow(slot, rows)
            Xs = slot.host_X[:rows].numpy().reshape(
                (S, nmax) + self.sample_shape)
            ints = slot.host_i.numpy()
            ns = ints[rows:rows + S]
            self._fill(Xs, ints[:rows].reshape(S, nmax), ns, client_ids,
                       split, n_real)
            data = np.zeros(slot.rows, bool)
            for j in range(S):
                data[j * nmax:j * nmax + ns[j]] = True
            copies = _runs(data)
            zeros = _runs(slot.data_rows & ~data)
            slot.data_rows = data
            t1 = time.perf_counter()
            if self._cuda:
                with torch.cuda.stream(self._copy_stream):
                    self._copy_stream.wait_event(slot.released)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    self._put_rows(slot, copies, zeros, rows + S)
                    end.record()
                    slot.copied.record()
                end.synchronize()
                put_ms = start.elapsed_time(end)
            else:
                self._put_rows(slot, copies, zeros, rows + S)
                put_ms = (time.perf_counter() - t1) * 1e3
        nbytes = (int(data.sum()) * int(np.prod(self.sample_shape))
                  * self.dtype.itemsize)
        with self._stats_lock:
            st = self.transfer_stats
            st["host_gather_ms"] += (t1 - t0) * 1e3
            st["device_put_ms"] += put_ms
            st["bytes"] += float(nbytes + 4 * (rows + S))
            st["fetches"] += 1
        X = slot.dev_X[:rows].view((S, nmax) + self.sample_shape)
        return (X, slot.dev_i[:rows].view(S, nmax),
                slot.dev_i[rows:rows + S], slot_i)

    def _put_rows(self, slot: _Slot, copies, zeros, n_ints: int) -> None:
        """On the current stream: the rows of ``copies`` host to device,
        the rows of ``zeros`` set to 0 on the device, and the int32 part
        (``y``, ``n``) whole."""
        nb = self._cuda
        for a, b in copies:
            slot.dev_X[a:b].copy_(slot.host_X[a:b], non_blocking=nb)
        for a, b in zeros:
            slot.dev_X[a:b].zero_()
        slot.dev_i[:n_ints].copy_(slot.host_i[:n_ints], non_blocking=nb)

    # ---------- the double buffer (main thread) ----------

    def _submit(self, key: tuple, client_ids, n_real: int | None) -> None:
        """Start a fetch into the slot not served, as the one pending. A
        pending fetch it replaces is never served (the single reader runs
        fetches in order, so the new one overwrites it)."""
        slot_i = 0 if self._served is None else 1 - self._served
        self._pending = (key, self._pool.submit(
            self._fetch_put, np.asarray(client_ids), key[0], n_real, slot_i))

    def _take(self, key: tuple):
        """Wait for the pending fetch ``key`` and serve it: the consumer's
        stream waits for its copy, and the slot served before is
        released."""
        if self._pending is None or self._pending[0] != key:
            raise RuntimeError(
                f"streamed walks interleaved: expected {key[:2]}, the "
                f"pending fetch is {self._pending and self._pending[0][:2]}")
        fut = self._pending[1]
        self._pending = None
        t0 = time.perf_counter()
        X, y, n, slot_i = fut.result()
        waited = (time.perf_counter() - t0) * 1e3
        self.wait_ms += waited
        if self._cuda:
            consumer = torch.cuda.current_stream(self.device)
            if consumer.query():  # no work left queued: the card waited
                self.idle_wait_ms += waited
            consumer.wait_event(self._slots[slot_i].copied)
            if self._served is not None and self._served != slot_i:
                self._slots[self._served].released.record(consumer)
        self._served = slot_i
        return X, y, n

    def _get(self, key: tuple, client_ids, n_real: int | None):
        """The fetch ``key``: the pending one where it matches, a fresh
        one otherwise (a mismatched prefetch is never served)."""
        if self._pending is None or self._pending[0] != key:
            self._submit(key, client_ids, n_real)
        return self._take(key)

    @staticmethod
    def _train_key(client_ids, n_real):
        return ("train", tuple(int(c) for c in client_ids), n_real)

    def prefetch_train(self, client_ids: np.ndarray,
                       n_real: int | None = None) -> None:
        """Start the read and copy of ``client_ids``' training rows behind
        the current compute. ``n_real``: entries from this index on are
        pad clients (zero rows, ``n`` 0)."""
        key = self._train_key(client_ids, n_real)
        if self._pending is None or self._pending[0] != key:
            self._submit(key, client_ids, n_real)

    def get_train(self, client_ids: np.ndarray, n_real: int | None = None):
        """``(X, y, n)`` of ``client_ids``' training rows on the device:
        the prefetched chunk where it matches, else a fresh read."""
        return self._get(self._train_key(client_ids, n_real), client_ids,
                         n_real)

    @staticmethod
    def _window_key(ids_per_round, n_real):
        return ("train", tuple(int(c) for ids in ids_per_round for c in ids),
                n_real, len(ids_per_round))

    def prefetch_window(self, ids_per_round: list[np.ndarray],
                        n_real: int | None = None) -> None:
        """Start the read and copy of a whole window's training rows (each
        round's ``ids``, all of one size) behind the current compute."""
        key = self._window_key(ids_per_round, n_real)
        if self._pending is None or self._pending[0] != key:
            self._submit(key, np.concatenate(
                [np.asarray(i) for i in ids_per_round]), None)

    def get_window(self, ids_per_round: list[np.ndarray],
                   n_real: int | None = None):
        """``(X, y, n)`` ``[K, S, nmax, ...]`` of a window's rounds on the
        device: the prefetched fetch where it matches, else a fresh read.
        ``n_real`` is the reference's mesh padding, always None here."""
        key = self._window_key(ids_per_round, n_real)
        X, y, n = self._get(key, np.concatenate(
            [np.asarray(i) for i in ids_per_round]), None)
        K = len(ids_per_round)
        S = len(ids_per_round[0])
        return (X.view((K, S) + tuple(X.shape[1:])),
                y.view((K, S) + tuple(y.shape[1:])), n.view(K, S))

    # ---------- resident validation rows (FedFomo) ----------

    def get_val_resident(self):
        """Every client's validation rows ``[C, nmax_val, ...]`` on the
        device, for good: the split is ``val_fraction``-small."""
        Xs, ys, ns = self._fetch(np.arange(self.num_clients), "val")
        put = lambda a: torch.from_numpy(a).to(self.device)
        return put(Xs), put(ys), put(ns)

    # ---------- chunked walks ----------

    @staticmethod
    def chunk_plan(ids, chunk_clients: int
                   ) -> list[tuple[np.ndarray, np.ndarray]]:
        """``ids`` cut into chunks of ``chunk_clients``: each chunk's real
        ids and those padded with the last id to the chunk size."""
        ids = np.asarray(ids, np.int64)
        out = []
        for start in range(0, len(ids), chunk_clients):
            real = ids[start:start + chunk_clients]
            out.append((real, np.concatenate(
                [real, np.full(chunk_clients - len(real), real[-1])])))
        return out

    def eval_chunks(self, chunk_clients: int, split: str = "test",
                    ids=None, then: tuple | None = None
                    ) -> Iterator[EvalChunk]:
        """Yield ``split``'s rows of ``ids`` (default: every client in
        order) in chunks of ``chunk_clients``, the last one padded with
        zero-row clients. Chunk k+1's read and copy start before chunk k is
        yielded, so both ride behind the caller's compute. ``then``:
        ``(ids, split)`` of the walk that comes next, whose first chunk is
        prefetched once this walk's last chunk is served."""
        ids = np.arange(self.num_clients) if ids is None else ids
        plan = self.chunk_plan(ids, chunk_clients)
        key = lambda real, padded, sp=split: (
            sp, tuple(int(c) for c in padded), len(real))
        if plan:
            real, padded = plan[0]
            if self._pending is None or self._pending[0] != key(real, padded):
                self._submit(key(real, padded), padded, len(real))
        for i, (real, padded) in enumerate(plan):
            X, y, n = self._take(key(real, padded))
            if i + 1 < len(plan):
                nxt = plan[i + 1]
                self._submit(key(*nxt), nxt[1], len(nxt[0]))
            elif then is not None:
                then_ids, then_split = then
                first = self.chunk_plan(then_ids, chunk_clients)[:1]
                if first:
                    self._submit(key(*first[0], sp=then_split), first[0][1],
                                 len(first[0][0]))
            yield EvalChunk(real, padded, X, y, n)

    def sync(self) -> None:
        """Wait until every fetch submitted so far has finished (the
        single reader runs them in order)."""
        self._pool.submit(lambda: None).result()

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        self._pending = None


def _runs(mask: np.ndarray) -> list[tuple[int, int]]:
    """The ``[start, end)`` runs of True in a boolean vector."""
    d = np.diff(np.concatenate([[0], mask.astype(np.int8), [0]]))
    return list(zip(np.flatnonzero(d == 1).tolist(),
                    np.flatnonzero(d == -1).tolist()))
