"""The sharded ingest plane: N selector worker processes, one root (the
reference package's ``asyncfl/ingest.py``).

One Python process holding every silo's connection spends its interpreter
on decode, admission and reply serialization. This module spreads them:

- **N worker processes, one port.** Every worker binds the same listen
  port with ``SO_REUSEPORT`` (``asyncfl/loop.py``) and runs the selector
  frame loop; the kernel balances connections across the listeners, so a
  silo's persistent connection keeps one worker for its lifetime. Workers
  decode uploads against their version ring, run the admission gates and
  FOLD accepted uploads into a local partial aggregate; only partials and
  small verdict events cross to the root over a pipe.
- **One merge algebra.** ``privacy/secure_quant.py``'s slot-major int64
  fold serves both paths: a ``--secure_quant`` worker folds field-element
  frames into a ``SlotAccumulator`` and exports centre-lifted int64 totals
  (``export_centered``); a dense worker quantizes each carried upload into
  the same fixed-point int64 lattice (``FoldSpec``). Integer addition is
  exact, commutative and associative, so the root's merge of partials in
  worker-id order equals folding every upload in one process bit for bit,
  for any worker count and partitioning. The fold is numpy int64 on the
  host, as in the reference.
- **Admission state.** Per-sender state (seq watermarks, the per-version
  dedup marks) partitions by connection: a re-delivery arrives on the same
  connection, and a reconnect re-registers. Staleness gates run against
  the worker's ring, which the root advances over the pipe (a FUTURE-tagged
  upload inside the pipe's latency is dropped and its sender re-synced).
  Registration, heartbeats, the aggregation trigger, the version and the
  audit live at the root, fed by verdict events.
- **The audit.** Verdicts stream to the root in batches, each flushed
  before the partial holding its uploads, so ``upload_audit()`` reconciles
  across workers: received = accepted + dropped, accepted = aggregated +
  buffered at workers + ``lost_with_worker`` (uploads a killed worker had
  accepted and never shipped, counted).

Refused at startup: server-side defenses and quarantine (the root sees
pre-folded partials, never a silo's update). A folded entry cannot be
taken out, so the one-slot-per-sender rule is out too.

Replies: every upload is answered at once; at an unchanged version the
reply carries no body (the silo holds that tree). Under ``sync_delta`` a
changed version goes to a silo that asked for it as the byte delta
against the version it last synced (``codec/wire.encode_sync_delta``),
dense when that base left the ring.

Numerics: the dense fold quantizes at ``2^-frac_bits`` absolute (default
2^-20) and the weights at ``2^-weight_frac_bits`` relative;
``make_fold_spec`` checks one upload's headroom at startup and the root
checks the total mass before every merge (a violation discards the buffer
as ``aggregation_discarded``, never wraps).

Workers are spawned (``mp.get_context("spawn")``: the root has usually
touched CUDA) and are host code: none calls into ``torch.cuda``.
"""

from __future__ import annotations

import dataclasses
import logging
import multiprocessing as mp
import sys
import threading
import time
from typing import Any

import numpy as np

from neuroimagedisttraining_tpu_torch.asyncfl.server import (
    BufferedFedAvgServer,
    staleness_weight,
)
from neuroimagedisttraining_tpu_torch.distributed import message as M
from neuroimagedisttraining_tpu_torch.distributed.comm import (
    BASE_PORT,
    BaseCommManager,
    Observer,
    QueueDispatchMixin,
)
from neuroimagedisttraining_tpu_torch.obs import fanin as obs_fanin
from neuroimagedisttraining_tpu_torch.obs import flight as obs_flight
from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
from neuroimagedisttraining_tpu_torch.obs import trace as obs_trace
from neuroimagedisttraining_tpu_torch.obs import names as obs_names
from neuroimagedisttraining_tpu_torch.obs import rules as obs_rules

log = logging.getLogger("neuroimagedisttraining_tpu_torch.asyncfl")

PyTree = Any

#: dense fixed-point fraction bits: value resolution 2^-20 absolute,
#: around the float32 epsilon for O(1) model parameters
INGEST_FRAC_BITS = 20
#: fixed-point bits for the integer fold weights (relative resolution
#: ~2^-10 on the staleness-discounted sample-count weights)
INGEST_WEIGHT_FRAC_BITS = 10
#: int64 totals must stay provably exact: the root refuses to merge a
#: buffer whose weight mass could push any coordinate past this
_INT64_SAFE = 1 << 62
#: verdict events are BATCHED worker-side (one pipe message per ~batch,
#: not per upload): at 1k+ uploads/s the root's per-event pipe recv +
#: counter work becomes the choke — batching moves the
#: fan-in cost off the per-upload path on BOTH ends of the pipe
VERDICT_BATCH_MAX = 64
#: a partially-filled batch never ages past this before flushing, so
#: the root's pending count (and the harvest trigger riding it) lags
#: the workers by at most one poll tick
VERDICT_BATCH_AGE_S = 0.05
#: flow-END events emitted per merged aggregation: enough
#: to causally link a representative set of uploads in the merged
#: trace without the event volume scaling with buffer_k
_FLOW_ENDS_MAX = 64


# ---------------------------------------------------------------------------
# fold algebra (shared by workers, the root merge, and the test replays)
# ---------------------------------------------------------------------------


def _named_leaves(tree: PyTree):
    from neuroimagedisttraining_tpu_torch.privacy.secure_quant import (
        _named_leaves as nl,
    )

    return nl(tree)


def _rebuild_like(template: PyTree, by_name: dict):
    from neuroimagedisttraining_tpu_torch.privacy.secure_quant import (
        _rebuild_like as rl,
    )

    return rl(template, by_name)


@dataclasses.dataclass(frozen=True)
class FoldSpec:
    """Geometry of the sharded fold — every worker and the root must
    hold the identical spec (it ships once, at worker spawn).

    ``quant`` is None for the dense int64 lattice or the
    ``privacy.QuantSpec`` of the secure field; ``value_bound`` is the
    per-coordinate magnitude the headroom math assumes (honest updates
    stay inside it; violations saturate sign-preservingly on the dense
    path and lean on the documented field margin on the secure path —
    the same contract as privacy/secure_quant.py); ``weight_ref``
    normalizes the staleness-discounted sample-count weights so typical
    weights land near 1.0 before fixed-point scaling."""

    frac_bits: int = INGEST_FRAC_BITS
    weight_frac_bits: int = INGEST_WEIGHT_FRAC_BITS
    value_bound: float = 16.0
    weight_ref: float = 32.0
    weight_cap: int = 1 << 20
    quant: Any = None  # privacy.QuantSpec | None

    # -- derived bounds --

    @property
    def q_max(self) -> int:
        """Per-coordinate magnitude bound of one folded upload, in
        lattice units (the dense clamp edge / the secure per-chunk
        aggregate bound)."""
        if self.quant is not None:
            return int(self.quant.p // 2)
        return int(round(self.value_bound * (1 << self.frac_bits)))

    @property
    def chunk_capacity(self) -> float:
        """Secure path: the fold weight mass one ``SlotAccumulator``
        chunk can hold before the aggregate could leave the field's
        centered range — the worker lifts the chunk into plain int64
        totals (``export_centered``) before crossing it."""
        assert self.quant is not None
        return (self.quant.p // 2) / (
            self.value_bound * (1 << self.quant.frac_bits))

    def weight_int(self, n: float, tau: int, alpha: float) -> int:
        """The integer fold weight of one accepted upload — a pure
        function of (n, tau, alpha), so it is identical no matter which
        worker folds the upload (the partition-independence the bitwise
        merge pin rests on). Ratios are preserved to ~2^-weight_frac_bits
        relative; weights below the lattice floor round up to 1 (an
        admitted upload never folds at zero) and weights above
        ``weight_cap`` saturate (documented, like value saturation)."""
        w = staleness_weight(n, tau, alpha) / self.weight_ref
        return int(min(self.weight_cap,
                       max(1, int(round(w * (1 << self.weight_frac_bits))))))

    def mass_bound(self) -> int:
        """Total integer weight mass one MERGED aggregation may hold
        with int64 exactness guaranteed; the root checks it before
        every merge."""
        if self.quant is not None:
            per = self.value_bound * (1 << self.quant.frac_bits)
        else:
            per = float(self.q_max)
        return int(_INT64_SAFE // max(1, int(per)))


def make_fold_spec(init_params: PyTree, quant=None,
                   weight_ref: float = 32.0,
                   frac_bits: int = INGEST_FRAC_BITS) -> FoldSpec:
    """Build + validate the run's fold geometry at STARTUP (never
    mid-run): the value bound starts from the init model's actual leaf
    magnitudes doubled for drift (the async secure-path precedent —
    BatchNorm raw-moment leaves dwarf any fixed constant), and the
    single-upload headroom (weight cap x value bound) must leave the
    int64 lattice room for thousands of uploads."""
    init_mag = max((float(np.max(np.abs(np.asarray(x, np.float64))))
                    for _, x in _named_leaves(init_params)
                    if np.asarray(x).size), default=0.0)
    value_bound = max(16.0, 2.0 * init_mag)
    if weight_ref <= 0:
        raise ValueError(f"ingest weight_ref must be > 0, got {weight_ref}")
    weight_cap = 1 << 20
    if quant is not None:
        cap = (quant.p // 2) / (value_bound * (1 << quant.frac_bits))
        # one upload must fit a chunk with room for at least 8 peers,
        # or every fold would lift a chunk (correct but pathological)
        weight_cap = int(cap / 8.0)
        if weight_cap < 1 << INGEST_WEIGHT_FRAC_BITS:
            raise ValueError(
                f"secure_quant field too small for the sharded ingest "
                f"fold at value bound {value_bound:.0f}: chunk capacity "
                f"{cap:.1f} weight units cannot resolve weight ratios "
                f"at {INGEST_WEIGHT_FRAC_BITS} fraction bits — raise "
                "--secure_quant_field_bits (32 recommended) or lower "
                "--secure_quant_frac_bits")
    spec = FoldSpec(frac_bits=int(frac_bits),
                    value_bound=float(value_bound),
                    weight_ref=float(weight_ref),
                    weight_cap=int(weight_cap), quant=quant)
    if spec.weight_cap * spec.q_max >= _INT64_SAFE:
        raise ValueError(
            f"ingest fold headroom exceeded: one upload at weight cap "
            f"{spec.weight_cap} x value range {spec.q_max} leaves no "
            f"int64 margin — lower frac_bits ({frac_bits}) or the "
            f"weight cap")
    return spec


class PartialAccumulator:
    """One process's partial aggregate: plain int64 totals + the
    integer weight mass. ``fold_dense`` quantizes a decoded upload
    into the lattice; ``fold_frame`` folds a secure-quant field frame
    through a ``SlotAccumulator`` chunk that is center-lifted into the
    totals before its mass could leave the field's range. ``merge`` is
    exact int64 addition — commutative, associative, so N partials
    merged in any order equal one accumulator that folded everything
    (THE sharded-ingest invariant).

    Storage is ONE flat int64 vector with fixed per-leaf offsets, so
    the per-upload hot path is a single short numpy op chain instead of
    a per-leaf dict walk (the per-leaf layout profiled at ~0.5 ms per
    upload — dominated by numpy call overhead on small leaves, not
    arithmetic); the element-wise operations are unchanged, so the
    totals are BITWISE what the per-leaf fold produced. The per-leaf
    dict view (``totals``) is derived by ``np.split`` on demand."""

    def __init__(self, spec: FoldSpec, sizes: list[tuple[str, int]]):
        self.spec = spec
        self.sizes = sizes
        self._splits = np.cumsum([s for _, s in sizes])[:-1]
        self._total_size = int(sum(s for _, s in sizes))
        self._flat: np.ndarray | None = None
        self.w_int_total = 0
        self.count = 0
        #: secure path: the in-progress SlotAccumulator chunk
        self._chunk = None
        self._chunk_mass = 0

    @property
    def totals(self) -> dict[str, np.ndarray] | None:
        """Per-leaf views into the flat totals (the wire/test shape)."""
        if self._flat is None:
            return None
        return {name: seg for (name, _), seg in
                zip(self.sizes, np.split(self._flat, self._splits))}

    # ---- dense ----

    def flatten_upload(self, u_eff: PyTree) -> np.ndarray:
        """One f32 vector in template leaf order; validates structure."""
        named = _named_leaves(u_eff)
        if [(n, int(np.asarray(x).size)) for n, x in named] != self.sizes:
            raise ValueError("upload leaf structure differs from the "
                             "model (version skew); upload discarded")
        return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                               for _, x in named])

    def fold_dense(self, u_eff: PyTree, w_int: int) -> None:
        self.fold_flat(self.flatten_upload(u_eff), w_int)

    def fold_flat(self, flat: np.ndarray, w_int: int) -> None:
        spec = self.spec
        if self._flat is None:
            self._flat = np.zeros(self._total_size, np.int64)
        scaled = np.rint(flat * np.float32(1 << spec.frac_bits))
        # NaN -> neutral zero contribution, +/-inf saturates sign-
        # preservingly (the quantize32 contract; the non-finite
        # admission gate makes this belt-over-braces)
        scaled = np.where(np.isnan(scaled), np.float32(0.0), scaled)
        q = np.clip(scaled, -float(spec.q_max),
                    float(spec.q_max)).astype(np.int64)
        self._flat += int(w_int) * q
        self.w_int_total += int(w_int)
        self.count += 1

    # ---- secure (field frames) ----

    def _lift_chunk(self) -> None:
        if self._chunk is None or self._chunk.folded == 0:
            return
        lifted = self._chunk.export_centered()
        if self._flat is None:
            self._flat = np.zeros(self._total_size, np.int64)
        self._flat += np.concatenate(
            [np.asarray(lifted[name], np.int64).reshape(-1)
             for name, _ in self.sizes])
        self._chunk = None
        self._chunk_mass = 0

    def fold_frame(self, frame: dict, w_int: int) -> None:
        from neuroimagedisttraining_tpu_torch.privacy import SlotAccumulator

        spec = self.spec
        if self._chunk is not None and \
                self._chunk_mass + w_int > spec.chunk_capacity:
            self._lift_chunk()
        if self._chunk is None:
            self._chunk = SlotAccumulator(spec.quant)
            # lock the chunk's structure to the model template
            self._chunk._sizes = list(self.sizes)
        self._chunk.fold(frame, weight_int=int(w_int))
        self._chunk_mass += int(w_int)
        self.w_int_total += int(w_int)
        self.count += 1

    # ---- export / merge / finalize ----

    def export(self) -> dict | None:
        """The wire form of this partial: center-lifted int64 totals +
        mass + count. None when nothing folded."""
        self._lift_chunk()
        if self._flat is None:
            return None
        return {"slots": self.totals, "w_int": self.w_int_total,
                "count": self.count}

    def merge_payload(self, payload: dict) -> None:
        """Exact int64 merge of one exported partial into this one."""
        self._lift_chunk()
        if self._flat is None:
            self._flat = np.zeros(self._total_size, np.int64)
        slots = payload["slots"]
        if sorted(slots) != sorted(name for name, _ in self.sizes):
            raise ValueError("partial leaf structure mismatch at merge")
        self._flat += np.concatenate(
            [np.asarray(slots[name], np.int64).reshape(-1)
             for name, _ in self.sizes])
        self.w_int_total += int(payload["w_int"])
        self.count += int(payload["count"])

    def finalize(self, like: PyTree) -> PyTree:
        """Dequantize the merged totals to the aggregated model:
        ``totals / (w_int_total * 2^frac_bits)`` in float64, reshaped and
        cast like the template. Deterministic in the totals alone."""
        self._lift_chunk()
        if self._flat is None or self.w_int_total == 0:
            raise ValueError("finalize() before any upload folded")
        fb = (self.spec.quant.frac_bits if self.spec.quant is not None
              else self.spec.frac_bits)
        denom = float(self.w_int_total) * float(1 << fb)
        totals = self.totals
        out = {}
        for name, x in _named_leaves(like):
            arr = np.asarray(x)
            out[name] = (totals[name].astype(np.float64) / denom
                         ).reshape(arr.shape).astype(arr.dtype)
        return _rebuild_like(like, out)


def model_sizes(like: PyTree) -> list[tuple[str, int]]:
    return [(name, int(np.asarray(x).size))
            for name, x in _named_leaves(like)]


def single_process_fold(entries: list[tuple], spec: FoldSpec,
                        like: PyTree) -> PartialAccumulator:
    """THE reference the multi-process merge is pinned against: fold
    every entry through ONE accumulator, in the given order. Entries are
    ``(u_eff_or_frame, w_int)``. Because the algebra is exact integer
    arithmetic, any partitioning of the same entries into per-worker
    accumulators, merged in any order, produces bitwise-identical
    totals."""
    acc = PartialAccumulator(spec, model_sizes(like))
    for payload, w_int in entries:
        if spec.quant is not None:
            acc.fold_frame(payload, w_int)
        else:
            acc.fold_dense(payload, w_int)
    return acc


# ---------------------------------------------------------------------------
# cross-worker exactly-once dedup
# ---------------------------------------------------------------------------


class SeqWatermarks:
    """Root-held upload-seq watermarks per (sender, incarnation).

    The per-worker watermark dedups transport re-deliveries on ONE
    connection; this table closes the cross-worker hole: marks of
    accepted (seq, incarnation) pairs ride every verdict batch up to
    the root, and when a sender RE-registers anywhere in the tree with
    the SAME incarnation (a reconnect — its monotone seq continues),
    the root sends the watermark floor back down to the new worker
    BEFORE that worker answers the register, so a re-sent upload the
    old worker already accepted is dropped as a duplicate instead of
    double-contributing. A register under a NEW incarnation is a
    restart: fresh floor, seq 0 legitimate — the documented
    reset-on-re-register semantics for legacy senders are untouched
    (no incarnation => no floor traffic at all). Not thread-safe by
    itself: the root mutates it under its event-loop lock."""

    def __init__(self):
        self._wm: dict[int, list[int]] = {}  # c -> [incarnation, max_seq]

    def register(self, c: int, inc: int) -> int:
        """Floor for a registering sender: its surviving watermark on a
        same-incarnation reconnect, -1 on a new incarnation."""
        cur = self._wm.get(int(c))
        if cur is not None and cur[0] == int(inc):
            return cur[1]
        self._wm[int(c)] = [int(inc), -1]
        return -1

    def advance(self, c: int, inc: int, seq: int) -> None:
        """One accepted-upload mark from a verdict batch. Marks from a
        superseded incarnation (an old worker's batch draining after
        the sender restarted) are ignored — latest incarnation wins."""
        cur = self._wm.get(int(c))
        if cur is None:
            self._wm[int(c)] = [int(inc), int(seq)]
        elif cur[0] == int(inc):
            cur[1] = max(cur[1], int(seq))

    def floor(self, c: int, inc: int) -> int:
        cur = self._wm.get(int(c))
        return cur[1] if cur is not None and cur[0] == int(inc) else -1


# ---------------------------------------------------------------------------
# shared-memory partial hand-off
# ---------------------------------------------------------------------------

#: slab header: int64 x3 — seqlock generation, w_int_total, count
_SHM_HEADER_BYTES = 24
#: double buffering: one slab being read by the parent while the next
#: export writes the other; both un-acked => pickled-pipe fallback
#: (counted, never blocked — exactness is transport-independent)
_SHM_SLABS = 2


class _ShmSlabWriter:
    """OWNER side of one partial-export slab: creates the segment,
    writes the flat int64 vector under a seqlock-style generation
    counter (odd while writing, even when consistent), and — on its
    teardown path — both ``close()``es AND ``unlink()``s it (the
    ``shm-discipline`` contract; a SIGKILLed owner's segment
    is reclaimed by multiprocessing's resource tracker instead)."""

    def __init__(self, total_size: int):
        from multiprocessing import shared_memory

        self.total_size = int(total_size)
        self.shm = shared_memory.SharedMemory(
            create=True, size=_SHM_HEADER_BYTES + self.total_size * 8)
        self.name = self.shm.name
        self._hdr = np.ndarray(3, np.int64, buffer=self.shm.buf)
        self._vec = np.ndarray(self.total_size, np.int64,
                               buffer=self.shm.buf,
                               offset=_SHM_HEADER_BYTES)
        self._hdr[:] = 0

    def write(self, segs: list[np.ndarray], w_int: int,
              count: int) -> int:
        """One exported partial into the slab; returns the (even)
        generation the reader must observe unchanged around its copy.
        The ack protocol makes a concurrent write impossible — the
        seqlock turns 'impossible' into 'loudly detected'."""
        gen = int(self._hdr[0])
        self._hdr[0] = gen + 1          # odd: write in progress
        if len(segs) == 1:
            np.copyto(self._vec, segs[0])
        else:
            np.concatenate(segs, out=self._vec)
        self._hdr[1] = int(w_int)
        self._hdr[2] = int(count)
        self._hdr[0] = gen + 2          # even: consistent
        return gen + 2

    def destroy(self) -> None:
        """Owner teardown: close the mapping AND unlink the name."""
        # numpy views export the buffer; drop them or close() raises
        self._hdr = self._vec = None
        try:
            self.shm.close()
        finally:
            try:
                self.shm.unlink()
            except FileNotFoundError:  # pragma: no cover
                pass


class _ShmSlabReader:
    """ATTACH side of one slab: copies the vector out under the
    generation check, then acks so the writer may reuse the slab. The
    attach side only ever ``close()``s — it must NEVER ``unlink()`` a
    segment it does not own (``shm-attach-unlink``); a dead
    owner's segment is the resource tracker's to reclaim."""

    def __init__(self, name: str, total_size: int):
        from multiprocessing import shared_memory

        self.total_size = int(total_size)
        self.shm = shared_memory.SharedMemory(name=name)
        self._hdr = np.ndarray(3, np.int64, buffer=self.shm.buf)
        self._vec = np.ndarray(self.total_size, np.int64,
                               buffer=self.shm.buf,
                               offset=_SHM_HEADER_BYTES)

    def read(self, gen: int) -> tuple[np.ndarray, int, int]:
        """``(flat_copy, w_int, count)`` — raises on a torn or stale
        generation instead of ever returning a silently-wrong vector
        (the audit would catch the count; the totals must never be
        guessable-wrong)."""
        g0 = int(self._hdr[0])
        flat = self._vec.copy()
        w_int, count = int(self._hdr[1]), int(self._hdr[2])
        g1 = int(self._hdr[0])
        if g0 != int(gen) or g1 != int(gen) or g0 % 2:
            raise RuntimeError(
                f"shm slab torn read: generation {g0}/{g1}, expected "
                f"{int(gen)} — writer reused an un-acked slab")
        return flat, w_int, count

    def close(self) -> None:
        self._hdr = self._vec = None
        try:
            self.shm.close()
        except (OSError, BufferError):  # pragma: no cover
            pass


# ---------------------------------------------------------------------------
# worker-side core (socket-free; unit-testable)
# ---------------------------------------------------------------------------


class IngestWorkerCore:
    """Admission + fold state of one ingest worker — everything the
    worker does per upload EXCEPT sockets and pipes, so the gates are
    unit-testable in-process. Mirrors ``BufferedFedAvgServer``'s
    admission verdicts key for key."""

    def __init__(self, wid: int, spec: FoldSpec, init_params: PyTree,
                 max_staleness: int, staleness_alpha: float,
                 wire_masks=None):
        self.wid = wid
        self.spec = spec
        self.params = init_params
        self.version = 0
        self.max_staleness = int(max_staleness)
        self.staleness_alpha = float(staleness_alpha)
        self.wire_masks = wire_masks
        self.sizes = model_sizes(init_params)
        self._ring: dict[int, PyTree] = {0: init_params}
        #: upload-lifecycle stage latencies: queue/decode/admit/fold
        #: observed here per upload, merge/aggregate at the root per
        #: aggregation
        self._stage_hist = obs_fanin.stage_histogram()
        self._stage_ns: dict[str, int] = {}
        self.partial = PartialAccumulator(spec, self.sizes)
        #: flat f32 cache of the ring (one flatten per VERSION, so the
        #: per-upload delta transport is three vector ops, not a
        #: per-leaf tree walk)
        self._flat_ring: dict[int, np.ndarray] = {
            0: self.partial.flatten_upload(init_params)}
        self._seq_seen: dict[int, int] = {}
        self._contributed: dict[int, set[int]] = {}
        self.registered: set[int] = set()
        self.last_synced: dict[int, int] = {}
        #: sender-lifetime nonces (reconnect vs restart) and
        #: the delta-sync capability set, both declared at registration
        self.incarnations: dict[int, int] = {}
        self.sync_delta_ok: set[int] = set()
        #: delta frames are shared by every client syncing (base ->
        #: current); cache one encode per pair, cleared on set_model
        self._delta_cache: dict[tuple[int, int], dict] = {}
        #: delta-sync accounting (honest fallback counts)
        self.sync_stats = {"sync_delta_sent": 0, "sync_dense_sent": 0,
                           "sync_dense_fallback_ring": 0}
        #: per-entry metadata riding the next exported partial:
        #: (client, tag_version, anchor_version, n, w_int, tau)
        self.entries: list[tuple] = []
        self.stats = {
            "received": 0, "accepted": 0, "dropped_stale": 0,
            "dropped_duplicate": 0, "dropped_future": 0,
            "dropped_quarantined": 0, "dropped_undecodable": 0,
            "dropped_nonfinite": 0, "dropped_after_done": 0,
            "dropped_malformed": 0,
        }
        self.done = False

    # ---- model/version plane (root -> worker) ----

    def set_model(self, version: int, params: PyTree) -> None:
        self.version = int(version)
        self.params = params
        self._ring[self.version] = params
        self._flat_ring[self.version] = \
            self.partial.flatten_upload(params)
        floor = self.version - self.max_staleness
        for old in [v for v in self._ring if v < floor]:
            del self._ring[old]
            self._flat_ring.pop(old, None)
        for c, seen in self._contributed.items():
            self._contributed[c] = {v for v in seen if v >= floor}
        # delta-sync frames against superseded versions are dead weight
        # (every changed-version reply now deltas against a new pair)
        self._delta_cache.clear()

    # ---- client plane ----

    def handle_register(self, c: int, incarnation: int | None = None,
                        delta_ok: bool = False) -> bool:
        """Returns True on first worker-local contact. A re-register —
        which is also how a connection migrates workers — resets the
        sender's LOCAL dedup state, exactly like the single-process
        server; a sender that declared an incarnation then has the
        root's cross-worker watermark floor applied via
        ``note_seqfloor`` BEFORE its register is answered,
        so a worker hop cannot double-contribute."""
        first = c not in self.registered
        self.registered.add(c)
        self._seq_seen.pop(c, None)
        self._contributed.pop(c, None)
        if incarnation is not None:
            self.incarnations[c] = int(incarnation)
        else:
            self.incarnations.pop(c, None)
        if delta_ok:
            self.sync_delta_ok.add(c)
        else:
            self.sync_delta_ok.discard(c)
        return first

    def note_seqfloor(self, c: int, inc: int, floor: int) -> None:
        """Apply the root's cross-worker watermark floor.
        Guarded by incarnation: a floor for a superseded incarnation
        (the sender restarted while the message was in flight) must not
        poison the fresh sender's seq space."""
        if self.incarnations.get(c) != int(inc):
            return
        if int(floor) > self._seq_seen.get(c, -1):
            self._seq_seen[c] = int(floor)

    def build_sync_body(self, c: int):
        """The model body of a CHANGED-version sync reply for sender
        ``c``: the lossless delta against the sender's last-synced
        version when it advertised the capability and the base is still
        in the broadcast ring, else the dense tree (fallback counted
        and logged — never silent). Returns ``(body, kind)`` with kind
        in {"dense", "delta", "dense_fallback_ring"}."""
        from neuroimagedisttraining_tpu_torch.codec import wire as codec

        base = self.last_synced.get(c)
        if (c not in self.sync_delta_ok or base is None
                or base == self.version):
            self.sync_stats["sync_dense_sent"] += 1
            return self.params, "dense"
        if base not in self._ring:
            log.info(
                "ingest worker %d: delta-sync base %d for client %d "
                "left the broadcast ring (current %d, floor %d); "
                "falling back to a dense body", self.wid, base, c,
                self.version, self.version - self.max_staleness)
            self.sync_stats["sync_dense_fallback_ring"] += 1
            return self.params, "dense_fallback_ring"
        key = (int(base), self.version)
        frame = self._delta_cache.get(key)
        if frame is None:
            frame = codec.encode_sync_delta(self.params,
                                            self._ring[base],
                                            base_version=base)
            self._delta_cache[key] = frame
        self.sync_stats["sync_delta_sent"] += 1
        return frame, "delta"

    def handle_upload(self, msg: M.Message) -> str:
        """One admission decision; returns the verdict key (a
        ``upload_stats`` key). Accepted uploads are folded into the
        local partial before this returns. Stage latencies (queue /
        decode / admit / fold) land in ``nidt_upload_stage_ms`` and,
        when the tracer is armed, the whole decision is one span with
        the upload's wire trace context rendered as a flow step."""
        t0 = time.perf_counter_ns()
        self.stats["received"] += 1
        if self.done:
            self.stats["dropped_after_done"] += 1
            return "dropped_after_done"
        self._stage_ns = {}
        if obs_trace.TRACER.armed:
            with obs_trace.span("ingest_upload", worker=self.wid,
                                client=int(msg.sender_id)):
                verdict = self._admit_guarded(msg)
        else:
            verdict = self._admit_guarded(msg)
        self.stats[verdict] += 1
        if verdict != "accepted":
            # drops are rare and each is a control-plane decision the
            # post-mortem wants; accepts are counted, not recorded
            # (the hot path stays one ring append per anomaly). These
            # ship to the root with worker provenance (obs/fanin.py).
            obs_flight.record(verdict, worker=self.wid,
                              client=int(msg.sender_id),
                              version=self.version)
        t1 = time.perf_counter_ns()
        recv_ns = getattr(msg, "recv_ns", None)
        if recv_ns is not None:
            self._stage_hist.observe((t0 - recv_ns) / 1e6, stage="queue")
        decode_ns = self._stage_ns.get("decode", 0)
        fold_ns = self._stage_ns.get("fold", 0)
        if decode_ns:
            self._stage_hist.observe(decode_ns / 1e6, stage="decode")
        if fold_ns:
            self._stage_hist.observe(fold_ns / 1e6, stage="fold")
        self._stage_hist.observe(
            max(0, (t1 - t0) - decode_ns - fold_ns) / 1e6, stage="admit")
        return verdict

    def _admit_guarded(self, msg: M.Message) -> str:
        try:
            return self._admit(msg)
        except Exception as e:  # noqa: BLE001 — broken FIELDS are a
            # dropped upload, never a dead worker dispatch thread (the
            # single-process server's contract)
            log.warning("ingest worker %d: dropping malformed upload "
                        "from %s (%s: %s)", self.wid, msg.sender_id,
                        type(e).__name__, e)
            return "dropped_malformed"

    def _admit(self, msg: M.Message) -> str:
        from neuroimagedisttraining_tpu_torch.codec import wire as codec

        c = msg.sender_id
        tag = msg.get(M.ARG_ROUND_IDX)
        v = self.version if tag is None else int(tag)
        tau = self.version - v
        if tau < 0:
            # the sender saw a fresher version than this worker knows —
            # only possible in the pipe-latency window after a root
            # advance, or after a reconnect raced a broadcast. Same
            # verdict as the single-process future gate; the reply
            # re-syncs the sender at this worker's version.
            log.warning("ingest worker %d: dropping upload from %d "
                        "tagged FUTURE version %d (worker at %d)",
                        self.wid, c, v, self.version)
            return "dropped_future"
        if tau > self.max_staleness:
            log.warning("ingest worker %d: dropping ancient upload from "
                        "%d (tag %d, current %d)", self.wid, c, v,
                        self.version)
            return "dropped_stale"
        seq = msg.get(M.ARG_UPLOAD_SEQ)
        if seq is not None:
            if int(seq) <= self._seq_seen.get(c, -1):
                return "dropped_duplicate"
            # watermark advances at the gate: a re-delivery repeats the
            # VERDICT, never the processing (server.py precedent)
            self._seq_seen[c] = int(seq)
        elif v in self._contributed.get(c, ()):
            return "dropped_duplicate"
        n = float(msg.get(M.ARG_NUM_SAMPLES))
        if not (np.isfinite(n) and n >= 0):
            raise ValueError(f"non-finite num_samples {n!r}")
        w_int = self.spec.weight_int(n, tau, self.staleness_alpha)
        fid = obs_trace.flow_id_of(msg.get(M.ARG_TRACE_CTX))
        if self.spec.quant is not None:
            from neuroimagedisttraining_tpu_torch.privacy import secure_quant as sq

            frame = msg.get(M.ARG_MODEL_PARAMS)
            t_dec = time.perf_counter_ns()
            try:
                sq._validate_frame(frame, self.spec.quant)
                if sq.SlotAccumulator._frame_sizes(frame) != self.sizes:
                    raise ValueError("frame leaf structure differs from "
                                     "the model (version skew)")
            except (ValueError, KeyError, TypeError) as e:
                log.warning("ingest worker %d: invalid secure frame "
                            "from %d: %s", self.wid, c, e)
                return "dropped_undecodable"
            finally:
                self._stage_ns["decode"] = time.perf_counter_ns() - t_dec
            if seq is None:
                self._contributed.setdefault(c, set()).add(v)
            t_fold = time.perf_counter_ns()
            self.partial.fold_frame(frame, w_int)
            self._stage_ns["fold"] = time.perf_counter_ns() - t_fold
            self.entries.append((c, v, None, n, w_int, tau, fid))
            self._note_flow(fid, c)
            return "accepted"
        ref = self._ring[v]
        t_dec = time.perf_counter_ns()
        try:
            masks = (dict(_named_leaves(self.wire_masks))
                     if self.wire_masks is not None else None)
            decoded = codec.decode_update(
                msg.get(M.ARG_MODEL_PARAMS),
                like=dict(_named_leaves(self.params)),
                reference=dict(_named_leaves(ref)), masks=masks)
            flat_u = self.partial.flatten_upload(decoded)
        except Exception as e:  # noqa: BLE001 — undecodable = dropped
            log.warning("ingest worker %d: undecodable upload from %d "
                        "(base %d): %s", self.wid, c, v, e)
            return "dropped_undecodable"
        finally:
            self._stage_ns["decode"] = time.perf_counter_ns() - t_dec
        if not np.isfinite(flat_u).all():
            log.warning("ingest worker %d: REJECTING non-finite upload "
                        "from %d (base %d)", self.wid, c, v)
            if seq is None:
                self._contributed.setdefault(c, set()).add(v)
            return "dropped_nonfinite"
        if seq is None:
            self._contributed.setdefault(c, set()).add(v)
        anchor = self.version
        if tau != 0:
            # delta-transport to the worker's CURRENT model (the fold-
            # time anchor, recorded per entry so a replay is exact):
            # u + (params_now - params_base), f32 like the buffered
            # server's transport — three vector ops on the flat cache,
            # element-wise identical to the per-leaf tree walk
            flat_u = flat_u + (self._flat_ring[self.version]
                               - self._flat_ring[v])
        t_fold = time.perf_counter_ns()
        self.partial.fold_flat(flat_u, w_int)
        self._stage_ns["fold"] = time.perf_counter_ns() - t_fold
        self.entries.append((c, v, anchor, n, w_int, tau, fid))
        self._note_flow(fid, c)
        return "accepted"

    def _note_flow(self, fid: int | None, c: int) -> None:
        """Flow STEP for an accepted upload (inside the
        ``ingest_upload`` span ``handle_upload`` holds open) — the
        worker hop of the client->worker->root flow chain."""
        if fid is not None and obs_trace.TRACER.armed:
            obs_trace.flow("upload", fid, "t", worker=self.wid,
                           client=int(c))

    def export_partial(self) -> dict | None:
        """Swap the in-progress partial out for the root (None when
        empty). Entry metadata rides along for history + replay."""
        payload = self.partial.export()
        if payload is None:
            return None
        payload["entries"] = self.entries
        self.partial = PartialAccumulator(self.spec, self.sizes)
        self.entries = []
        return payload


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------


def _send_tolerant(comm, msg: M.Message) -> bool:
    """Best-effort reply; returns False on failure so the caller can
    avoid recording state the peer never received (e.g. last_synced —
    a client whose full-body sync was dropped must get the body again
    on its next upload, not a body-less sync at a version it never
    saw)."""
    try:
        comm.send_message(msg, retries=1)
        return True
    except (ConnectionError, OSError) as e:
        log.debug("ingest worker: reply to %d failed (%s)",
                  msg.receiver_id, e)
        return False


class _IngestWorkerProc(Observer):
    """The process wrapper: one ``SelectorCommManager`` (SO_REUSEPORT)
    for client frames, one pipe to the root. A single lock orders every
    fold against the verdict event that reports it and the partial
    export that ships it — the FIFO pipe then guarantees the root sees
    events strictly before the partial containing them."""

    def __init__(self, wid: int, core: IngestWorkerCore, comm, conn,
                 use_shm: bool = False, sync_delta: bool = False):
        self.wid = wid
        self.core = core
        self.comm = comm
        self.conn = conn
        self.sync_delta = bool(sync_delta)
        self._lock = threading.Lock()
        #: verdict batch (under _lock): counts per verdict + the taus of
        #: accepted entries — ONE "vb" pipe message per batch instead of
        #: one "v" per upload, flushed on size, age, or before any
        #: partial/bye so the root still sees every verdict strictly
        #: before the partial that contains it
        self._vb_counts: dict[str, int] = {}
        self._vb_taus: list[int] = []
        self._vb_n = 0
        #: accepted-upload watermark marks riding the next vb flush
        #:: c -> (incarnation, max accepted seq)
        self._vb_marks: dict[int, tuple[int, int]] = {}
        #: registers deferred until the root's seqfloor answers (the
        #: sender uploads only after its sync reply, so the floor is in
        #: place before any post-migration upload can race it)
        self._pending_reg: dict[int, bool] = {}
        #: shm partial hand-off: double-buffered slabs owned
        #: by THIS process; pipe carries control dicts, acks free slabs
        self._slabs: list[_ShmSlabWriter] = []
        self._free_slabs: list[int] = []
        if use_shm:
            self._slabs = [_ShmSlabWriter(core.partial._total_size)
                           for _ in range(_SHM_SLABS)]
            self._free_slabs = list(range(len(self._slabs)))
        #: transport accounting: shm against pipe exports
        self._xstats = {"shm_exports": 0, "pipe_exports": 0,
                        "shm_export_ns": 0, "pipe_export_ns": 0,
                        "shm_fallback_busy": 0}
        #: heartbeat batch (under _lock): per-client
        #: beats fold into ONE "beats" pipe message per flush interval
        #: — at cross-device scale the per-beat pipe events were the
        #: next unbatched fan-in after the verdicts; repeats from the
        #: same client within one interval are SUPPRESSED (counted)
        self._beats_pending: set[int] = set()
        self._obs_beats_suppressed = obs_metrics.gauge(
            obs_names.INGEST_HEARTBEATS_SUPPRESSED,
            "per-client heartbeats folded away by worker-side batching "
            "(duplicates within one flush interval)")
        #: telemetry shipper: registry snapshot + span/flight
        #: chunks, one "obs" pipe message per interval — never per frame
        self._shipper = obs_fanin.WorkerObsShipper()
        comm.add_observer(self)
        self._pipe_thread = threading.Thread(target=self._pipe_loop,
                                             daemon=True)

    def _vb_add_locked(self, verdict: str, tau) -> None:
        self._vb_counts[verdict] = self._vb_counts.get(verdict, 0) + 1
        if tau is not None:
            self._vb_taus.append(int(tau))
        self._vb_n += 1
        if self._vb_n >= VERDICT_BATCH_MAX:
            self._flush_verdicts_locked()

    def _flush_verdicts_locked(self) -> None:
        if self._beats_pending:
            # heartbeats ride the same flush cadence as the verdict
            # batches but are ordering-independent of the audit (only
            # vb-before-partial is an invariant)
            self.conn.send(("beats", self.wid,  # nidt: allow[lock-send] -- every caller holds self._lock (the _locked suffix contract); the one pipe has no other writer thread outside it
                            sorted(self._beats_pending)))
            self._beats_pending.clear()
        if not self._vb_n:
            return
        self.conn.send(("vb", self.wid, self._vb_counts, self._vb_taus,  # nidt: allow[lock-send] -- every caller holds self._lock (the _locked suffix contract); the one pipe has no other writer thread outside it
                        self._vb_marks))
        self._vb_counts, self._vb_taus, self._vb_n = {}, [], 0
        self._vb_marks = {}

    def _ship_obs_locked(self, force: bool = False) -> None:
        """Under ``_lock``: one batched telemetry payload per interval
        (rate-limited by the shipper; ``force`` for the pre-bye final
        ship so the root's merged artifacts include the tail)."""
        payload = self._shipper.payload(force=force)
        if payload is not None:
            self.conn.send(("obs", self.wid, payload))  # nidt: allow[lock-send] -- caller holds self._lock (the _locked suffix contract); the one pipe has no other writer thread outside it

    def run(self) -> None:
        self._pipe_thread.start()
        with self._lock:
            self.conn.send(("ready", self.wid))
            if self._slabs:
                # announced BEFORE any partial can reference a slab
                # (same FIFO pipe), so the parent attaches in time
                self.conn.send(("shm_names", self.wid,
                                [s.name for s in self._slabs],
                                self._slabs[0].total_size))
        self.comm.handle_receive_message()

    # ---- root pipe (its own thread) ----

    def _pipe_loop(self) -> None:
        while True:
            try:
                if not self.conn.poll(VERDICT_BATCH_AGE_S):
                    # quiet tick: age out a partially-filled batch so
                    # the root's pending count never lags for long;
                    # the telemetry shipper rate-limits itself to one
                    # payload per OBS_SHIP_INTERVAL_S on the same tick
                    with self._lock:
                        self._flush_verdicts_locked()
                        self._ship_obs_locked()
                    continue
                cmd = self.conn.recv()
            except (EOFError, OSError):
                # root died: nothing to aggregate into — stop serving
                log.warning("ingest worker %d: root pipe closed; "
                            "shutting down", self.wid)
                self._destroy_slabs()
                self.comm.stop_receive_message()
                return
            kind = cmd[0]
            if kind == "model":
                with self._lock:
                    self.core.set_model(cmd[1], cmd[2])
            elif kind == "flush":
                with self._lock:
                    # verdicts strictly BEFORE the partial containing
                    # them (same pipe, FIFO)
                    self._flush_verdicts_locked()
                    self._export_locked(cmd[1])
            elif kind == "shm_ack":
                # parent copied the slab out: free it for reuse
                with self._lock:
                    self._free_slabs.append(int(cmd[1]))
            elif kind == "seqfloor":
                self._on_seqfloor(cmd[1], cmd[2], cmd[3])
            elif kind == "clock":
                # spawn-time clock handshake (obs/fanin.py): echo the
                # root's t0 with this process's perf_counter reading;
                # the root estimates the offset at the pipe's midpoint
                with self._lock:
                    self.conn.send(("clock_reply", self.wid, cmd[1],
                                    time.perf_counter_ns()))
            elif kind == "finish":
                self._finish()
                return

    def _export_locked(self, seq: int) -> None:
        """Under ``_lock``: export the staged partial and ship it —
        through a free shm slab when transport is enabled and one is
        un-acked-free (O(control) pipe message), else pickled through
        the pipe (the documented cross-host fallback, also taken when
        both slabs are still in flight)."""
        t0 = time.perf_counter_ns()
        payload = self.core.export_partial()
        if payload is None:
            self.conn.send(("partial", self.wid, seq, None,  # nidt: allow[lock-send] -- caller holds self._lock (the _locked suffix contract); the one pipe has no other writer thread outside it
                            dict(self.core.stats)))
            return
        if self._slabs and self._free_slabs:
            idx = self._free_slabs.pop()
            gen = self._slabs[idx].write(
                [payload["slots"][name] for name, _ in self.core.sizes],
                payload["w_int"], payload["count"])
            ctrl = {"shm": idx, "gen": gen,
                    "entries": payload["entries"]}
            self.conn.send(("partial", self.wid, seq, ctrl,  # nidt: allow[lock-send] -- caller holds self._lock (the _locked suffix contract); the one pipe has no other writer thread outside it
                            dict(self.core.stats)))
            self._xstats["shm_exports"] += 1
            self._xstats["shm_export_ns"] += \
                time.perf_counter_ns() - t0
            return
        if self._slabs:
            self._xstats["shm_fallback_busy"] += 1
        self.conn.send(("partial", self.wid, seq, payload,  # nidt: allow[lock-send] -- caller holds self._lock (the _locked suffix contract); the one pipe has no other writer thread outside it
                        dict(self.core.stats)))
        self._xstats["pipe_exports"] += 1
        self._xstats["pipe_export_ns"] += time.perf_counter_ns() - t0

    def _destroy_slabs(self) -> None:
        """Owner teardown: close AND unlink every slab exactly once."""
        slabs, self._slabs, self._free_slabs = self._slabs, [], []
        for s in slabs:
            s.destroy()

    def _on_seqfloor(self, c: int, inc: int, floor: int) -> None:
        """Root answered a deferred register: install the surviving
        watermark, then release the held INIT/SYNC reply."""
        with self._lock:
            self.core.note_seqfloor(c, inc, floor)
            first = self._pending_reg.pop(c, None)
            if first is None:
                return
            done = self.core.done
            version, params = self.core.version, self.core.params
        if done:
            _send_tolerant(self.comm,
                           M.Message(M.MSG_TYPE_S2C_FINISH, 0, c))
            return
        self._send_reg_reply(c, first, version, params)

    def _finish(self) -> None:
        with self._lock:
            self.core.done = True
            registered = sorted(self.core.registered)
        for c in registered:
            _send_tolerant(self.comm,
                           M.Message(M.MSG_TYPE_S2C_FINISH, 0, c))
        drain = getattr(self.comm, "drain_sends", None)
        if drain is not None:
            drain(5.0)
        with self._lock:
            self._flush_verdicts_locked()
            obs_flight.record("worker_finish", worker=self.wid,
                              residual=self.core.partial.count,
                              received=self.core.stats["received"])
            # final telemetry ship BEFORE the bye (same pipe, FIFO):
            # the root drains it while waiting on byes, so the merged
            # artifacts include this worker's tail
            self._ship_obs_locked(force=True)
            residual = self.core.partial.count
            xs = {**self._xstats, **self.core.sync_stats}
            self.conn.send(("bye", self.wid, dict(self.core.stats),
                            residual, self.comm.byte_stats(),
                            self.comm.peak_connections, xs))
        # the worker's LOCAL trace dump (the .wN-suffixed secondary
        # artifact; the root's merged trace is the primary)
        obs_trace.dump()
        self._destroy_slabs()
        self.comm.stop_receive_message()

    # ---- client frames (dispatch thread) ----

    def receive_message(self, msg_type: str, msg: M.Message) -> None:
        if msg_type == M.MSG_TYPE_C2S_SEND_MODEL:
            self._on_model(msg)
        elif msg_type == M.MSG_TYPE_C2S_REGISTER:
            self._on_register(msg)
        elif msg_type == M.MSG_TYPE_C2S_HEARTBEAT:
            # batched: the beat joins the pending
            # set and crosses the pipe in ONE "beats" message at the
            # next flush tick (<= VERDICT_BATCH_AGE_S away, far inside
            # any sane heartbeat timeout); a repeat beat from the same
            # client inside one interval carries no extra liveness
            # information and is suppressed, counted in the gauge
            with self._lock:
                if msg.sender_id in self._beats_pending:
                    self._obs_beats_suppressed.inc()
                else:
                    self._beats_pending.add(msg.sender_id)
        else:
            log.warning("ingest worker %d: dropping unexpected %s from "
                        "%s", self.wid, msg_type, msg.sender_id)

    def _on_register(self, msg: M.Message) -> None:
        c = msg.sender_id
        inc = msg.get(M.ARG_CLIENT_INCARNATION)
        delta_ok = bool(msg.get(M.ARG_SYNC_DELTA_OK)) and self.sync_delta
        with self._lock:
            if self.core.done:
                _send_tolerant(self.comm,
                               M.Message(M.MSG_TYPE_S2C_FINISH, 0, c))
                return
            first = self.core.handle_register(c, incarnation=inc,
                                              delta_ok=delta_ok)
            if inc is not None:
                # the reply is DEFERRED until the root's seqfloor
                # lands: the sender uploads only after its sync reply,
                # so the cross-worker watermark is installed before any
                # post-migration upload can race it
                self._pending_reg[c] = first
                self.conn.send(("reg", self.wid, c, int(inc)))
                return
            self.conn.send(("reg", self.wid, c))
            version, params = self.core.version, self.core.params
        self._send_reg_reply(c, first, version, params)

    def _send_reg_reply(self, c: int, first: bool, version: int,
                        params) -> None:
        out = M.Message(M.MSG_TYPE_S2C_INIT_CONFIG if first
                        else M.MSG_TYPE_S2C_SYNC_MODEL, 0, c)
        out.add(M.ARG_MODEL_PARAMS, params)
        out.add(M.ARG_ROUND_IDX, version)
        if _send_tolerant(self.comm, out):
            # recorded only on DELIVERED body: a dropped sync must not
            # turn the client's next reply body-less at a version it
            # never saw
            with self._lock:
                self.core.last_synced[c] = version

    def _on_model(self, msg: M.Message) -> None:
        c = msg.sender_id
        with self._lock:
            verdict = self.core.handle_upload(msg)
            if verdict == "accepted":
                tau = self.core.entries[-1][5] if self.core.entries \
                    else 0
                self._vb_add_locked(verdict, int(tau))
                seq = msg.get(M.ARG_UPLOAD_SEQ)
                inc = self.core.incarnations.get(c)
                if seq is not None and inc is not None:
                    # accepted-seq mark rides the next vb flush so the
                    # root watermark covers a later worker hop
                    prev = self._vb_marks.get(c)
                    if (prev is None or prev[0] != inc
                            or int(seq) > prev[1]):
                        self._vb_marks[c] = (inc, int(seq))
            else:
                self._vb_add_locked(verdict, None)
            done = self.core.done
            version = self.core.version
            fresh = self.core.last_synced.get(c) != version
            body = None
            if not done and fresh:
                body, _kind = self.core.build_sync_body(c)
        if done:
            _send_tolerant(self.comm,
                           M.Message(M.MSG_TYPE_S2C_FINISH, 0, c))
            return
        out = M.Message(M.MSG_TYPE_S2C_SYNC_MODEL, 0, c)
        out.add(M.ARG_ROUND_IDX, version)
        if fresh:
            # the sender's model is behind: ship a body. At an
            # unchanged version the body is OMITTED — the sender holds
            # that exact tree already (cached-sync contract,
            # cross_silo.FedAvgClientProc) — which removes the per-
            # upload model serialization from the hot path entirely.
            # A delta-capable sender gets the lossless delta against
            # its last-synced version when that base is still in the
            # broadcast ring (build_sync_body).
            out.add(M.ARG_MODEL_PARAMS, body)
        if _send_tolerant(self.comm, out) and fresh:
            # recorded only on DELIVERED body (see _on_register)
            with self._lock:
                self.core.last_synced[c] = version


def _ingest_worker_main(wid: int, conn, wcfg: dict) -> None:
    """Spawned worker entry point (multiprocessing 'spawn' context —
    fresh interpreter, fresh obs registry, no CUDA context: a worker is
    host code and never calls into ``torch.cuda``)."""
    from neuroimagedisttraining_tpu_torch.asyncfl.loop import SelectorCommManager

    # per-process obs plane: a spawned worker starts with a
    # fresh registry/tracer/flight ring. Arm the tracer when the root's
    # is armed; LOCAL artifact paths are .wN-suffixed so N workers
    # inheriting one --trace_out/--flight_out never clobber one file —
    # the root's MERGED artifacts at the bare paths are the primary ones
    ocfg = wcfg.get("obs") or {}
    if ocfg.get("trace"):
        obs_trace.arm(
            obs_fanin.suffixed_path(ocfg.get("trace_path", ""), wid)
            or None,
            tags={"role": "ingest-worker", "worker": wid})
    obs_flight.configure(
        capacity=ocfg.get("flight_capacity"),
        path=obs_fanin.suffixed_path(ocfg.get("flight_path", ""), wid))

    core = IngestWorkerCore(
        wid, wcfg["spec"], wcfg["init_params"],
        max_staleness=wcfg["max_staleness"],
        staleness_alpha=wcfg["staleness_alpha"],
        wire_masks=wcfg.get("wire_masks"))
    # inline dispatch: the worker's per-frame work (admission + integer
    # fold + a body-less reply) is small and bounded, so it runs ON the
    # frame-loop thread — the queue handoff's two futex wakeups per
    # upload were the measured throughput choke on sandboxed kernels
    comm = SelectorCommManager(0, wcfg["world_size"],
                               host_map=wcfg.get("host_map"),
                               base_port=wcfg["base_port"],
                               send_timeout=2.0, reuse_port=True,
                               inline_dispatch=True)
    worker = _IngestWorkerProc(wid, core, comm, conn,
                               use_shm=bool(wcfg.get("shm")),
                               sync_delta=bool(wcfg.get("sync_delta")))
    try:
        worker.run()
    except Exception:  # noqa: BLE001 — log the real error before the
        # process dies; the root sees the sentinel either way
        log.exception("ingest worker %d crashed", wid)
        raise


# ---------------------------------------------------------------------------
# root server
# ---------------------------------------------------------------------------


class NullCommManager(QueueDispatchMixin, BaseCommManager):
    """The root's placeholder transport: the WORKERS own every client
    socket, so the root must never bind the port or dial a client."""

    rank = "ingest-root"

    def __init__(self):
        self._init_dispatch()

    def send_message(self, msg: M.Message, **kw) -> None:
        raise RuntimeError(
            "the ingest root has no client transport: worker processes "
            "own the sockets (asyncfl/ingest.py)")

    def handle_receive_message(self) -> None:  # pragma: no cover
        pass

    def stop_receive_message(self) -> None:
        self._stop_dispatch()


class ShardedIngestServer(BufferedFedAvgServer):
    """The root of the sharded ingest plane: spawns ``ingest_workers``
    selector worker processes on ONE ``SO_REUSEPORT`` port, counts their
    per-upload verdict events, and — every ``buffer_k`` accepted uploads
    (shrunk by known-gone clients, ``_k_eff``) — harvests each worker's
    partial and merges them in worker-id order. The merge is exact
    int64 addition, so the aggregated model is BITWISE what one process
    folding the same uploads would produce (module docstring; pinned).

    Inherits the buffered server's accounting/audit/obs machinery; its
    per-upload admission path is unused (workers run the gates) and
    server-side defenses/quarantine are rejected at construction — the
    root only ever sees pre-folded partials."""

    #: audit key for uploads buffered at a child when it died — the
    #: hierarchical tier's children are whole REGIONS, so it overrides
    #: this to "lost_with_region" (asyncfl/region.py)
    _lost_key = "lost_with_worker"

    def __init__(self, init_params, comm_round: int, num_clients: int,
                 ingest_workers: int = 2, buffer_k: int = 0,
                 staleness_alpha: float = 0.5, max_staleness: int = 20,
                 base_port: int | None = None,
                 world_size: int | None = None, secure_quant=None,
                 ingest_weight_ref: float = 32.0,
                 heartbeat_timeout: float = 0.0, wire_masks=None,
                 host_map: dict[int, str] | None = None,
                 spawn_timeout: float = 180.0, trace_out: str = "",
                 flight_out: str = "", use_shm: bool = False,
                 sync_delta: bool = False, **kw):
        if ingest_workers < 1:
            raise ValueError(
                f"ingest_workers must be >= 1, got {ingest_workers}")
        if kw.get("defense", "none") != "none" \
                or kw.get("quarantine_rounds", 0):
            raise ValueError(
                "the sharded ingest plane supports neither server-side "
                "defenses nor quarantine: workers fold uploads into "
                "partial aggregates, so the root never sees per-client "
                "updates to select over or score (matrix precedent: the "
                "buffered secure path; use the single-process plane or "
                "client-side clipping)")
        self.ingest_workers = int(ingest_workers)
        # the parent ctor must not run its one-phase secure capacity
        # checks (the ingest fold has its own geometry) and must not
        # build a listening comm — workers own the port
        super().__init__(init_params, comm_round, num_clients,
                         buffer_k=buffer_k,
                         staleness_alpha=staleness_alpha,
                         max_staleness=max_staleness,
                         world_size=world_size, comm=NullCommManager(),
                         heartbeat_timeout=heartbeat_timeout, **kw)
        self.upload_stats["lost_with_worker"] = 0
        self.upload_stats[self._lost_key] = 0
        self.fold_spec = make_fold_spec(self.params, quant=secure_quant,
                                        weight_ref=ingest_weight_ref)
        self.ingest_quant = secure_quant
        self.wire_masks_ingest = wire_masks
        self.base_port = BASE_PORT if base_port is None else int(base_port)
        # ---- per-worker obs + merge flight events ----
        self._obs_pending = obs_metrics.gauge(
            obs_names.INGEST_PENDING_UPLOADS,
            "accepted uploads buffered at ingest workers, awaiting "
            "harvest")
        self._obs_workers = obs_metrics.gauge(
            obs_names.INGEST_WORKERS_LIVE, "ingest worker processes alive")
        self._obs_partials = obs_metrics.counter(
            obs_names.INGEST_PARTIALS,
            "partials harvested per ingest worker",
            labelnames=("worker",))
        self._obs_worker_uploads = obs_metrics.counter(
            obs_names.INGEST_WORKER_UPLOADS,
            "per-worker upload verdict events at the root",
            labelnames=("worker", "outcome"))
        # ---- federation-wide telemetry fan-in ----
        # workers ship registry snapshots / span chunks / flight events
        # over the verdict pipes; this merges them into ONE exposition
        # (metrics_view), ONE trace and ONE flight dump (dump_obs). The
        # BARE --trace_out/--flight_out paths are the merged artifacts;
        # workers write .wN-suffixed local secondaries.
        self.trace_out = trace_out
        self.flight_out = flight_out
        self.fanin = self._make_fanin()
        self._stage_hist = obs_fanin.stage_histogram()
        self._obs_dumped = False
        # ---- cross-worker exactly-once ----
        # root-held accepted-seq watermarks, advanced by vb marks and
        # answered to deferred registers so a worker/region-hopping
        # client cannot double-contribute
        self._watermarks = SeqWatermarks()
        # cached flat layout for rebuilding shm partial slots
        self._fold_sizes = model_sizes(self.params)
        self._fold_splits = np.cumsum(
            [n for _, n in self._fold_sizes])[:-1]
        # ---- worker processes ----
        ctx = mp.get_context("spawn")
        wcfg = {"spec": self.fold_spec, "init_params": self.params,
                "max_staleness": self.max_staleness,
                "staleness_alpha": self.staleness_alpha,
                "wire_masks": wire_masks,
                "host_map": host_map,
                "world_size": world_size or num_clients + 1,
                "base_port": self.base_port,
                "shm": bool(use_shm),
                "sync_delta": bool(sync_delta),
                "obs": {"trace": bool(trace_out) or obs_trace.TRACER.armed,
                        "trace_path": trace_out,
                        "flight_path": flight_out,
                        "flight_capacity": obs_flight.FLIGHT.capacity}}
        self._workers: dict[int, dict] = {}
        for wid in range(self.ingest_workers):
            proc, parent = self._spawn_child(ctx, wid, wcfg)
            self._workers[wid] = {
                "proc": proc, "conn": parent, "alive": True,
                "acc": 0, "folded": 0, "partials": 0,
                "stats": None, "residual": 0, "bye": False,
                "byte_stats": None, "peak_conns": 0,
                "xstats": None, "shm": None, "last_partial_t": None,
            }
        deadline = time.monotonic() + spawn_timeout
        ready: set[int] = set()
        while len(ready) < self.ingest_workers:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._kill_workers()
                raise RuntimeError(
                    f"ingest workers not ready within {spawn_timeout}s "
                    f"({sorted(ready)} of {self.ingest_workers})")
            for wid, w in self._workers.items():
                if wid in ready:
                    continue
                try:
                    if w["conn"].poll(0.05):
                        msg = w["conn"].recv()
                        if msg[0] == "ready":
                            ready.add(wid)
                except (EOFError, OSError) as e:
                    # a worker that died during spawn (bind failure,
                    # import error) must surface as the named startup
                    # failure, with no orphan siblings left running
                    self._kill_workers()
                    raise RuntimeError(
                        f"ingest worker {wid} died during startup "
                        f"({type(e).__name__}); see its log output"
                    ) from e
        self._obs_workers.set(self.ingest_workers)
        self._harvest_waiting: set[int] | None = None
        self._harvest_parts: list[tuple[int, dict]] = []
        self._harvest_seq = 0
        self._staged: list[tuple[int, dict]] = []
        self._finishing = False
        # spawn-time clock handshake: probe, then collect the replies
        # HERE rather than on the event loop — run() may start seconds
        # after this ctor returns (a load harness spawns its fleet in
        # between), and a reply aging in the pipe would inflate t1 by
        # that gap, so the estimated offset would absorb half of it
        # and misalign every worker timeline in the merged trace
        for wid, w in self._workers.items():
            self._register_fanin(wid)
            try:
                w["conn"].send(("clock", time.perf_counter_ns()))  # nidt: allow[lock-send] -- ctor is single-threaded: the event loop and monitor threads do not exist yet
            except (BrokenPipeError, OSError):
                pass
        deadline = time.monotonic() + 2.0
        pending = set(self._workers)
        while pending and time.monotonic() < deadline:
            for wid in sorted(pending):
                w = self._workers[wid]
                try:
                    while w["conn"].poll(0.02):
                        ev = w["conn"].recv()
                        with self._rlock:
                            # early frames (a fast client's reg/vb) are
                            # dispatched normally, never dropped
                            self._handle_event(wid, ev)
                        if ev[0] == "clock_reply":
                            pending.discard(wid)
                            break
                except (EOFError, OSError):
                    pending.discard(wid)  # death surfaces in run()
        if pending:
            log.warning("ingest root: no clock reply from workers %s "
                        "within 2s; their merged-trace timelines fall "
                        "back to offset 0", sorted(pending))
        log.info("ingest root: %d workers ready on port %d",
                 self.ingest_workers, self.base_port)

    def _make_fanin(self) -> obs_fanin.TelemetryFanIn:
        """Fan-in label tiers — one ``worker`` tier here; the
        hierarchical root overrides with ``("region", "worker")``."""
        return obs_fanin.TelemetryFanIn()

    def _register_fanin(self, wid: int) -> None:
        """Register the fan-in key(s) one direct child contributes —
        a region child registers every (region, worker) pair."""
        self.fanin.register_worker(wid)

    def _spawn_child(self, ctx, wid: int, wcfg: dict):
        """Spawn ONE direct child (an ingest worker here; a regional
        sub-aggregator in ``HierarchicalIngestServer``) and return
        ``(process, parent_conn)`` — the override point that lets the
        hierarchical tier reuse the whole root event loop, because a
        region speaks the exact worker pipe protocol upstream."""
        parent, child = ctx.Pipe(duplex=True)
        proc = ctx.Process(target=_ingest_worker_main,
                           args=(wid, child, wcfg), daemon=True,
                           name=f"nidt-ingest-w{wid}")
        proc.start()
        child.close()
        return proc, parent

    # ---- introspection (tests, the smoke) ----

    @property
    def worker_pids(self) -> list[int]:
        return [w["proc"].pid for w in self._workers.values()]

    def worker_xstats(self) -> dict[str, int]:
        """Summed per-worker transport/sync accounting from the byes
        (shm vs pipe export counts + ns, delta-sync counts)."""
        out: dict[str, int] = {}
        for w in self._workers.values():
            xs = w["xstats"]
            if xs:
                for k, v in xs.items():
                    out[k] = out.get(k, 0) + int(v)
        return out

    def live_workers(self) -> list[int]:
        return [wid for wid, w in self._workers.items() if w["alive"]]

    def peak_connection_estimate(self) -> int:
        return sum(w["peak_conns"] for w in self._workers.values())

    def worker_byte_stats(self) -> dict[str, int]:
        out = {"bytes_sent": 0, "bytes_recv": 0, "frames_sent": 0,
               "frames_recv": 0}
        for w in self._workers.values():
            bs = w["byte_stats"]
            if bs:
                for k in out:
                    out[k] += bs.get(k, 0)
        return out

    def _observe_health_boundary(self) -> None:
        """Anomaly rules on the sharded root evaluate the fan-in-MERGED
        snapshot (obs/fanin.py): root cells plus every worker's cells
        re-labeled ``worker="N"`` — a rule's label-subset selector fires
        on a worker's series exactly as on a local one."""
        if obs_rules.active() is None:
            # unarmed: skip the O(metrics x workers)
            # merge on the aggregation hot path, not just the verdict
            return
        obs_rules.observe_boundary(self.round_idx,
                                   snapshot=self.fanin.merged_snapshot())

    def metrics_view(self):
        """The MERGED registry view ``--metrics_port`` should serve
        under ``--ingest_workers``: root samples + worker samples
        (``worker`` label) + snapshot-staleness gauges. Pass as the
        ``registry`` of ``obs.http.start_metrics_server``."""
        return self.fanin.metrics_view()

    def dump_obs(self, reason: str = "end of run"
                 ) -> dict[str, str | None]:
        """Write the MERGED obs artifacts at the bare configured paths
        (idempotent; called at end of run and on the crash path with a
        truthful ``reason``). The merged trace is the primary
        ``--trace_out`` artifact — workers only write ``.wN``-suffixed
        local secondaries."""
        with self._rlock:
            if self._obs_dumped:
                return {}
            self._obs_dumped = True
        out: dict[str, str | None] = {}
        if self.trace_out:
            out["trace"] = self.fanin.dump_trace(self.trace_out)
            log.info("ingest root: merged trace -> %s", out["trace"])
        if self.flight_out:
            out["flight"] = self.fanin.dump_flight(self.flight_out,
                                                   reason=reason)
            log.info("ingest root: merged flight dump -> %s (%s)",
                     out["flight"], reason)
        return out

    # ---- the root event loop ----

    def run(self) -> None:
        if self.heartbeat_timeout > 0:
            threading.Thread(target=self._monitor_loop,
                             daemon=True).start()
        try:
            while not self._done.is_set():
                self._poll_once()
        finally:
            crashed = sys.exc_info()[0] is not None
            if not self._done.is_set():
                # crashed out of the loop: leave no orphan processes
                self._kill_workers()
                self._done.set()
            # merged obs artifacts even on the crash/all-workers-dead
            # paths (idempotent: the clean path dumped in _finish_join)
            self.dump_obs(reason="failure" if crashed else "end of run")
            if crashed and self.flight_out:
                # the caller's failure_context is about to dump the
                # ROOT ring (with its "failure" event) to the default
                # flight path — point it at a sibling so it cannot
                # clobber the merged artifact with a root-only view;
                # both post-mortems survive, truthfully labeled
                obs_flight.configure(path=self.flight_out + ".root")

    def _poll_once(self, timeout: float = 0.1) -> None:
        conns = {w["conn"]: wid for wid, w in self._workers.items()
                 if w["alive"]}
        sentinels = {w["proc"].sentinel: wid
                     for wid, w in self._workers.items() if w["alive"]}
        if not conns:
            # every worker is gone: nothing can ever arrive again (the
            # normal FINISH path sets _done from _finish_join; this is
            # the all-workers-crashed case)
            with self._rlock:
                if not self._done.is_set() and not self._finishing:
                    log.error("ingest root: every worker died; "
                              "finishing with %d aggregations",
                              len(self.history))
                    self._done.set()
            time.sleep(timeout)
            return
        try:
            ready = mp.connection.wait(
                list(conns) + list(sentinels), timeout=timeout)
        except OSError:
            ready = []
        # pipes BEFORE sentinels: a worker that exited may have verdict/
        # partial events still buffered in its pipe — processing the
        # sentinel first would count those uploads lost_with_worker and
        # then double-count them when the pipe drains
        for obj in ready:
            if obj in conns:
                self._drain_conn(conns[obj])
        for obj in ready:
            if obj in sentinels:
                self._mark_worker_dead(sentinels[obj], "process exited")
        with self._rlock:
            self._maybe_harvest()

    def _drain_conn(self, wid: int) -> None:
        w = self._workers[wid]
        while True:
            try:
                if not w["conn"].poll():
                    return
                ev = w["conn"].recv()
            except (EOFError, OSError):
                self._mark_worker_dead(wid, "pipe closed")
                return
            with self._rlock:
                self._handle_event(wid, ev)

    def _handle_event(self, wid: int, ev: tuple) -> None:
        """Under ``_rlock``: one worker event."""
        w = self._workers[wid]
        kind = ev[0]
        if kind == "vb":
            # one "vb" event per worker-side BATCH of processed frames:
            # received and the verdict bumps land in LOCKSTEP at the
            # root, so the received == accepted + dropped audit holds
            # across processes exactly as it does in-process — at a
            # per-batch, not per-upload, fan-in cost
            counts, taus = ev[2], ev[3]
            self._stat("received", sum(counts.values()))
            for verdict, n in counts.items():
                self._stat(verdict, n)
                self._obs_worker_uploads.inc(n, worker=str(wid),
                                             outcome=verdict)
            acc_n = counts.get("accepted", 0)
            if acc_n:
                w["acc"] += acc_n
                for tau in taus:
                    self._obs_staleness.observe(tau)
                self._obs_pending.set(self._pending())
            if len(ev) > 4 and ev[4]:
                # accepted-seq marks: advance the root
                # watermark so a later re-register on ANY worker
                # inherits the floor
                for c, (inc, seq) in ev[4].items():
                    self._watermarks.advance(c, inc, seq)
        elif kind == "reg":
            c = ev[2]
            self._registered.add(c)
            self._suspect.discard(c)
            self._last_beat[c] = time.monotonic()
            if len(ev) > 3 and ev[3] is not None:
                # incarnation-carrying register: answer the surviving
                # watermark — the worker holds the client's reply until
                # this seqfloor lands (exactly-once across hops)
                inc = int(ev[3])
                floor = self._watermarks.register(c, inc)
                try:
                    w["conn"].send(("seqfloor", c, inc, floor))  # nidt: allow[lock-send] -- caller holds _rlock (method contract) and the event loop is the ONLY thread that ever writes a worker pipe
                except (BrokenPipeError, OSError):
                    self._mark_worker_dead_locked(wid,
                                                  "seqfloor send failed")
        elif kind == "beat":
            c = ev[2]
            self._last_beat[c] = time.monotonic()
            self._suspect.discard(c)
        elif kind == "beats":
            # worker-side batched heartbeats: one
            # pipe event per flush interval carrying every client that
            # beat in it — liveness granularity is the flush interval,
            # far inside any sane heartbeat timeout
            now = time.monotonic()
            for c in ev[2]:
                self._last_beat[c] = now
                self._suspect.discard(c)
        elif kind == "obs":
            # batched telemetry payload -> the fan-in (snapshots, span
            # chunks, flight events); ordering-independent of the
            # vb-before-partial audit invariant
            self.fanin.ingest(wid, ev[2])
        elif kind == "clock_reply":
            self.fanin.note_clock(wid, ev[2], ev[3],
                                  time.perf_counter_ns())
        elif kind == "shm_names":
            # worker announced its slabs (FIFO-before any shm partial):
            # attach read-only views; NEVER unlinked here — the worker
            # owns the segments and unlinks on ITS teardown
            w["shm"] = [_ShmSlabReader(name, ev[3]) for name in ev[2]]
        elif kind == "partial":
            seq, payload, stats = ev[2], ev[3], ev[4]
            w["stats"] = stats
            if isinstance(payload, dict) and "shm" in payload:
                payload = self._resolve_shm_partial(wid, payload)
            if payload is not None:
                w["last_partial_t"] = time.monotonic()
                w["folded"] += int(payload["count"])
                w["partials"] += 1
                self._obs_partials.inc(worker=str(wid))
                if seq == self._harvest_seq and \
                        self._harvest_waiting is not None:
                    self._harvest_parts.append((wid, payload))
                else:
                    # unsolicited (headroom) or late partial: stage it
                    # for the next merge — never dropped
                    self._staged.append((wid, payload))
            if self._harvest_waiting is not None \
                    and seq == self._harvest_seq:
                self._harvest_waiting.discard(wid)
                if not self._harvest_waiting:
                    self._complete_harvest()
        elif kind == "bye":
            w["stats"], w["residual"] = ev[2], ev[3]
            w["byte_stats"], w["peak_conns"] = ev[4], ev[5]
            if len(ev) > 6:
                w["xstats"] = ev[6]
            w["bye"] = True
        elif kind == "ready":
            pass
        else:  # pragma: no cover
            log.warning("ingest root: unknown worker event %r", kind)

    def _resolve_shm_partial(self, wid: int, ctrl: dict) -> dict:
        """Under ``_rlock``: materialize a shm-transported partial —
        copy the flat int64 vector out of the slab (seqlock-checked),
        ack the slab back to the worker for reuse, rebuild the
        per-leaf slots from the cached flat layout."""
        w = self._workers[wid]
        idx = int(ctrl["shm"])
        flat, w_int, count = w["shm"][idx].read(ctrl["gen"])
        try:
            w["conn"].send(("shm_ack", idx))  # nidt: allow[lock-send] -- caller holds _rlock (method contract) and the event loop is the ONLY thread that ever writes a worker pipe
        except (BrokenPipeError, OSError):
            pass  # death surfaces on the sentinel; the copy is ours
        segs = np.split(flat, self._fold_splits)
        slots = {name: seg
                 for (name, _), seg in zip(self._fold_sizes, segs)}
        return {"slots": slots, "w_int": int(w_int),
                "count": int(count), "entries": ctrl["entries"]}

    def _pending(self) -> int:
        """Under ``_rlock``: accepted uploads not yet merged, lost, or
        reported residual — the buffer occupancy of the sharded plane."""
        return sum(max(0, w["acc"] - w["folded"] - w["residual"])
                   for w in self._workers.values())

    def _maybe_harvest(self) -> None:
        """Under ``_rlock``: start a harvest when the distributed buffer
        has filled (or finish the run when the target is reached)."""
        if self._done.is_set() or self._finishing:
            return
        if self._harvest_waiting is not None:
            # a dead worker can never answer; don't wait for it
            self._harvest_waiting &= set(self.live_workers())
            if not self._harvest_waiting:
                self._complete_harvest()
            return
        if self._pending() >= self._k_eff() or self._staged:
            self._begin_harvest()

    def _begin_harvest(self) -> None:
        self._harvest_seq += 1
        self._harvest_parts = []
        waiting = set()
        for wid in self.live_workers():
            try:
                self._workers[wid]["conn"].send(  # nidt: allow[lock-send] -- caller holds _rlock (method contract) and the event loop is the ONLY thread that ever writes a worker pipe
                    ("flush", self._harvest_seq))
                waiting.add(wid)
            except (BrokenPipeError, OSError):
                self._mark_worker_dead_locked(wid, "flush send failed")
        self._harvest_waiting = waiting
        if not waiting:
            self._complete_harvest()

    def _complete_harvest(self) -> None:
        """Under ``_rlock``: merge the harvested partials in worker-id
        order and advance the version. Partials staged from headroom
        flushes ride the same merge."""
        parts = sorted(self._staged + self._harvest_parts,
                       key=lambda p: p[0])
        self._staged, self._harvest_parts = [], []
        self._harvest_waiting = None
        if not parts:
            return
        t_merge = time.perf_counter_ns()
        acc = PartialAccumulator(self.fold_spec, model_sizes(self.params))
        entries: list[tuple] = []
        for wid, payload in parts:
            acc.merge_payload(payload)
            entries.extend(payload["entries"])
        self._stage_hist.observe(
            (time.perf_counter_ns() - t_merge) / 1e6, stage="merge")
        if acc.w_int_total > self.fold_spec.mass_bound():
            # int64 exactness no longer provable: discard the buffer
            # loudly (the secure path's aggregation_discarded contract),
            # never merge values that may have wrapped
            log.error("ingest root: merged weight mass %d exceeds the "
                      "exactness bound %d - discarding %d uploads, "
                      "model unchanged", acc.w_int_total,
                      self.fold_spec.mass_bound(), acc.count)
            self._stat("aggregation_discarded", acc.count)
            obs_flight.record("aggregation_discarded",
                              version=self.round_idx, uploads=acc.count,
                              error="ingest mass bound exceeded")
            return
        entries.sort(key=lambda e: (e[0], e[1]))
        t_agg = time.perf_counter_ns()
        self.params = acc.finalize(self.params)
        self._stage_hist.observe(
            (time.perf_counter_ns() - t_agg) / 1e6, stage="aggregate")
        self.round_idx += 1
        if obs_trace.TRACER.armed:
            # flow ENDS for the merged uploads' wire trace contexts
            # (entry element 6), inside an aggregate span so Perfetto
            # has a slice to bind the arrows to; capped per merge
            with obs_trace.span("aggregate", version=self.round_idx,
                                clients=acc.count):
                flows = 0
                for e in entries:
                    fid = e[6] if len(e) > 6 else None
                    if fid is None:
                        continue
                    obs_trace.flow("upload", fid, "f",
                                   version=self.round_idx)
                    flows += 1
                    if flows >= _FLOW_ENDS_MAX:
                        break
        self._ring[self.round_idx] = self.params
        floor = self.round_idx - self.max_staleness
        for old in [k for k in self._ring if k < floor]:
            del self._ring[old]
        senders = [e[0] for e in entries]
        obs_flight.record(
            "partial_merge", version=self.round_idx,
            workers={str(wid): int(p["count"]) for wid, p in parts},
            clients=len(senders), w_int=acc.w_int_total)
        obs_flight.record("aggregate", version=self.round_idx,
                          clients=len(senders),
                          taus=[int(e[5]) for e in entries])
        self._obs_round_gauge.set(self.round_idx)
        self._obs_k_eff.set(self._k_eff())
        self._obs_pending.set(self._pending())
        self.history.append({
            "version": self.round_idx, "clients": len(senders),
            "contributors": senders,
            "taus": [int(e[5]) for e in entries],
            "weights": [float(e[4]) for e in entries],
            "entries": entries,
            "workers": {int(wid): int(p["count"]) for wid, p in parts},
            "t": time.monotonic()})
        if self.round_idx >= self.comm_round:
            self._begin_finish()
            return
        for wid in self.live_workers():
            try:
                self._workers[wid]["conn"].send(  # nidt: allow[lock-send] -- caller holds _rlock (method contract) and the event loop is the ONLY thread that ever writes a worker pipe
                    ("model", self.round_idx, self.params))
            except (BrokenPipeError, OSError):
                self._mark_worker_dead_locked(wid, "model send failed")

    def _mark_worker_dead(self, wid: int, why: str) -> None:
        """Takes ``_rlock``; event-loop callers that already hold it use
        ``_mark_worker_dead_locked`` directly (the lock is not
        reentrant)."""
        with self._rlock:
            self._mark_worker_dead_locked(wid, why)

    def _mark_worker_dead_locked(self, wid: int, why: str) -> None:
        w = self._workers[wid]
        if not w["alive"]:
            return
        # drain whatever the worker managed to ship before dying: a
        # SIGKILLed process's pipe still holds its written events, and
        # every event drained here is an upload that is NOT lost
        try:
            while w["conn"].poll():
                self._handle_event(wid, w["conn"].recv())
        except (EOFError, OSError):
            pass
        w["alive"] = False
        if w["shm"]:
            # attach-side teardown: close our mappings ONLY — the
            # (dead) worker owned the segments; unlink is its job (or
            # the resource tracker's, for a SIGKILL)
            readers, w["shm"] = w["shm"], None
            for r in readers:
                r.close()
        self.fanin.mark_dead(wid)  # last snapshot stays, marked stale
        lost = max(0, w["acc"] - w["folded"] - w["residual"])
        if lost and not w["bye"]:
            # accepted uploads that died WITH the child: accounted
            # explicitly so the audit reconciles instead of leaking
            # (lost_with_worker on a flat root, lost_with_region when
            # the dead child is a whole region)
            self.upload_stats[self._lost_key] += lost
            self._obs_uploads.inc(lost, outcome=self._lost_key)
            w["folded"] += lost
        self._obs_workers.set(len(self.live_workers()))
        obs_flight.record("worker_dead", worker=wid, why=why,
                          lost=lost, version=self.round_idx)
        log.warning("ingest root: worker %d dead (%s); %d buffered "
                    "uploads lost with it", wid, why, lost)
        if self._harvest_waiting is not None:
            self._harvest_waiting.discard(wid)
            if not self._harvest_waiting:
                self._complete_harvest()

    # ---- finish ----

    def _begin_finish(self) -> None:
        """Under ``_rlock``: tell every worker to FINISH its clients,
        then collect byes on the event loop until they exit."""
        self._finishing = True
        for wid in self.live_workers():
            try:
                self._workers[wid]["conn"].send(  # nidt: allow[lock-send] -- caller holds _rlock (method contract) and the event loop is the ONLY thread that ever writes a worker pipe
                    ("finish",))
            except (BrokenPipeError, OSError):
                self._mark_worker_dead_locked(wid, "finish send failed")
        threading.Thread(target=self._finish_join, daemon=True).start()

    def _finish_join(self) -> None:
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            with self._rlock:
                if all(w["bye"] or not w["alive"]
                       for w in self._workers.values()):
                    break
            time.sleep(0.05)
        self._kill_workers(join_first=True)
        # every worker's final pre-bye obs payload has been drained by
        # the event loop by now — write the merged artifacts
        self.dump_obs()
        self._done.set()
        self.finish()

    def _kill_workers(self, join_first: bool = False) -> None:
        for w in self._workers.values():
            p = w["proc"]
            if join_first:
                p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
            w["alive"] = False
            if w["shm"]:
                readers, w["shm"] = w["shm"], None
                for r in readers:
                    r.close()

    def _maybe_complete(self) -> None:
        """The heartbeat monitor's nudge: a fresh suspect may have
        lowered ``_k_eff`` below the pending count — the event loop's
        next tick (<= 100 ms) runs ``_maybe_harvest``, so nothing to do
        here beyond keeping the gauge honest."""
        self._obs_k_eff.set(self._k_eff())

    # ---- audit ----

    def upload_audit(self) -> dict:
        """Cross-worker frame accounting: verdict events make
        ``received == accepted + dropped`` hold at the root in real
        time, and every accepted upload is in a merged aggregation,
        still buffered at a worker, reported residual at FINISH, or
        explicitly ``lost_with_worker`` — zero silently lost, zero
        double-counted, across processes."""
        with self._rlock:
            s = dict(self.upload_stats)
            dropped = sum(v for k, v in s.items()
                          if k.startswith("dropped_"))
            aggregated = sum(h["clients"] for h in self.history
                             if "version" in h)
            buffered = self._pending() + sum(
                w["residual"] for w in self._workers.values())
            audit = {
                **s,
                "aggregated": aggregated,
                "buffered": buffered,
                "workers": {wid: {"alive": w["alive"], "acc": w["acc"],
                                  "folded": w["folded"],
                                  "partials": w["partials"]}
                            for wid, w in self._workers.items()},
                "received_accounted":
                    s["received"] == s["accepted"] + dropped,
                "accepted_accounted":
                    s["accepted"] == (aggregated + buffered
                                      + s.get("lost_with_worker", 0)
                                      + s.get("lost_with_region", 0)
                                      + s["aggregation_discarded"]),
            }
        if not (audit["received_accounted"]
                and audit["accepted_accounted"]):
            obs_flight.record("audit_failure", version=self.round_idx,
                              audit={k: v for k, v in audit.items()
                                     if isinstance(v, (int, bool))})
            out = obs_flight.dump(reason="ingest upload_audit failure")
            log.error("ingest root: upload audit FAILED (%s)%s", audit,
                      f" - flight recorder dumped to {out}" if out
                      else "")
        return audit
