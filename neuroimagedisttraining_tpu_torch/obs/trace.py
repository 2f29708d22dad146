"""Span tracer: the host's timeline as Chrome trace-event JSON (the
reference package's ``obs/trace.py``).

The host queues the card's work ahead of it, so a span measures host time
between host boundaries (an evaluation, a window, a round's dispatch, the
flush of its outputs), never device time, and never adds a sync to read a
clock. Under ``--profile_dir`` each span also opens an NVTX range
(``torch.cuda.nvtx.range_push`` / ``range_pop``) and a
``torch.profiler.record_function`` range of the same name, where the
reference opened a ``jax.profiler.TraceAnnotation``: the span names then
appear on the profiler's timeline beside the kernels they enclose.

- Stdlib only (torch is imported when a span opens a range).
- Thread-safe: every thread appends to one buffer under a lock; events
  carry the OS thread id, so Perfetto lays threads out as tracks.
- Nestable: spans are context managers; Chrome "X" (complete) events
  nest by time containment on a thread.
- Cheap when disarmed: ``span()`` returns a shared no-op context manager
  (no allocation, no clock read).

Output: ``{"traceEvents": [...], "displayTimeUnit": "ms"}`` with "X"
events ``{name, ph, ts, dur, pid, tid, args}`` (microseconds since the
tracer was armed, monotonic clock), which Perfetto and
``chrome://tracing`` load.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

__all__ = ["SpanTracer", "TRACER", "span", "instant", "flow", "arm",
           "disarm", "dump", "make_trace_ctx", "flow_id_of"]

#: flow-event phases (Chrome trace-event format): start / step / end;
#: Perfetto draws an arrow chain through the slices that enclose them
FLOW_PHASES = ("s", "t", "f")


def make_trace_ctx(rank: int, seq: int) -> dict:
    """The wire trace context a silo stamps on every upload
    (``distributed.message.ARG_TRACE_CTX``): ``trace_id`` is unique by
    (sender, upload), ``span_id`` names the sender. Each hop that handles
    the upload emits a flow event carrying the same id, so one upload
    reads as one linked track in the merged trace."""
    return {"trace_id": (int(rank) << 24) | (int(seq) & 0xFFFFFF),
            "span_id": int(rank)}


def flow_id_of(ctx) -> int | None:
    """The flow id of a wire trace context; None for a missing or
    malformed one (a telemetry path never raises on a peer's frame)."""
    if not isinstance(ctx, dict):
        return None
    tid = ctx.get("trace_id")
    if isinstance(tid, bool) or not hasattr(tid, "__index__"):
        return None  # ints only (msgpack may hand back numpy scalars)
    return int(tid)


class _NullSpan:
    """Shared no-op context manager — the disarmed fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    """One live span: records a Chrome "X" event on exit; under an
    armed annotation it holds an NVTX range and a
    ``torch.profiler.record_function`` range of its name open for its
    lifetime."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_ann")

    def __init__(self, tracer: "SpanTracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0
        self._ann = None

    def __enter__(self):
        t = self._tracer
        if t._annotate:
            try:
                import torch

                ann = torch.profiler.record_function(self.name)
                ann.__enter__()
                nvtx = torch.cuda.is_available()
                if nvtx:
                    torch.cuda.nvtx.range_push(self.name)
                self._ann = (ann, nvtx)
            except Exception:  # noqa: BLE001 — tracing must never be
                # the thing that stops a run
                self._ann = None
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._ann is not None:
            ann, nvtx = self._ann
            try:
                if nvtx:
                    import torch

                    torch.cuda.nvtx.range_pop()
                ann.__exit__(*exc)
            except Exception:  # noqa: BLE001 — see __enter__
                pass
        self._tracer._record(self.name, self._t0, t1, self.args)
        return False


class SpanTracer:
    """Per-process span buffer. Arm with an output path; every
    ``span()`` between arm and ``dump()`` lands in the trace. Tracer-
    level ``tags`` (rank, role, ...) merge into every event's args —
    the per-process key the multi-silo timeline is joined on."""

    #: event-buffer cap (~80 MB of dicts at ~300 B/event): a multi-hour
    #: armed run must not grow host memory without bound — events past
    #: the cap are DROPPED and counted (bounded-buffer honesty, the
    #: flight ring's rule), keeping the PREFIX of the run, which is
    #: what a Perfetto session of a long run gets opened on anyway
    DEFAULT_MAX_EVENTS = 1 << 18

    def __init__(self):
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._armed = False
        self._annotate = False
        self._path: str | None = None
        self._tags: dict[str, Any] = {}
        self._epoch_ns = time.perf_counter_ns()
        self._max_events = self.DEFAULT_MAX_EVENTS
        self._dropped = 0

    # ---- lifecycle ----

    @property
    def armed(self) -> bool:
        return self._armed

    @property
    def epoch_ns(self) -> int:
        """The ``perf_counter_ns`` instant event timestamps are relative
        to."""
        return self._epoch_ns

    def arm(self, path: str | None = None, *, annotate: bool = False,
            tags: dict | None = None,
            max_events: int | None = None) -> None:
        """Start recording. ``annotate=True`` also opens an NVTX range
        and a ``record_function`` range a span (``--profile_dir``: the
        host spans appear on the profiler's timeline);
        ``tags`` ride in every event's args; ``max_events`` caps the
        buffer (default ``DEFAULT_MAX_EVENTS``; excess events are
        dropped and counted in the dump's ``nidtDroppedEvents``)."""
        with self._lock:
            self._path = path
            self._annotate = bool(annotate)
            self._tags = dict(tags or {})
            self._epoch_ns = time.perf_counter_ns()
            self._events.clear()
            self._max_events = (self.DEFAULT_MAX_EVENTS
                                if max_events is None
                                else int(max_events))
            self._dropped = 0
            self._armed = True

    def disarm(self) -> None:
        with self._lock:
            self._armed = False
            self._annotate = False

    # ---- recording ----

    def span(self, name: str, **args: Any):
        """Context manager for one host span. Disarmed: a shared no-op
        (no allocation, no clock read)."""
        if not self._armed:
            return _NULL
        return _Span(self, name, args)

    def instant(self, name: str, **args: Any) -> None:
        """Zero-duration marker (Chrome "i" instant event)."""
        if not self._armed:
            return
        ts = (time.perf_counter_ns() - self._epoch_ns) / 1e3
        with self._lock:
            if not self._armed:
                return
            if len(self._events) >= self._max_events:
                self._dropped += 1
                return
            self._events.append({
                "name": name, "ph": "i", "s": "t",
                "ts": ts, "pid": os.getpid(),
                "tid": threading.get_ident(),
                "args": {**self._tags, **args}})

    def flow(self, name: str, flow_id: int, phase: str,
             **args: Any) -> None:
        """One flow event: ``phase`` "s" (start), "t" (step) or "f" (end).
        Perfetto binds each to the "X" slice enclosing its timestamp on
        its thread and draws the arrows through the slices that share
        ``flow_id``, so emit it inside a live span. An end carries
        ``bp: "e"`` (bind to the enclosing slice)."""
        if not self._armed:
            return
        if phase not in FLOW_PHASES:
            raise ValueError(f"flow phase must be one of {FLOW_PHASES}, "
                             f"got {phase!r}")
        ts = (time.perf_counter_ns() - self._epoch_ns) / 1e3
        ev = {"name": name, "ph": phase, "cat": "flow",
              "id": int(flow_id), "ts": ts, "pid": os.getpid(),
              "tid": threading.get_ident(),
              "args": {**self._tags, **args}}
        if phase == "f":
            ev["bp"] = "e"
        with self._lock:
            if not self._armed:
                return
            if len(self._events) >= self._max_events:
                self._dropped += 1
                return
            self._events.append(ev)

    def _record(self, name: str, t0_ns: int, t1_ns: int,
                args: dict) -> None:
        ev = {
            "name": name, "ph": "X",
            "ts": (t0_ns - self._epoch_ns) / 1e3,
            "dur": (t1_ns - t0_ns) / 1e3,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": {**self._tags, **args},
        }
        with self._lock:
            if not self._armed:
                return
            if len(self._events) >= self._max_events:
                self._dropped += 1
                return
            self._events.append(ev)

    # ---- output ----

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def events_from(self, start: int) -> tuple[list[dict], int]:
        """Incremental read for periodic shipping (``obs/fanin.py``):
        events recorded since index ``start`` plus the new watermark.
        ``arm()`` clears the buffer, so a shipper resets its watermark
        when it re-arms."""
        with self._lock:
            evs = list(self._events[start:])
            return evs, start + len(evs)

    def dump(self, path: str | None = None) -> str | None:
        """Write the Chrome trace JSON; returns the path written (None
        when no path was armed or given, OR when the write failed —
        every caller dumps from a ``finally``, and an unwritable
        ``--trace_out`` must neither mask the run's real exception nor
        fail a successful run at exit; flight.dump keeps the same
        contract). Safe to call repeatedly — the buffer is kept, so a
        mid-run dump is a prefix of the final."""
        with self._lock:
            out = path or self._path
            if not out:
                return None
            doc = {"traceEvents": list(self._events),
                   "displayTimeUnit": "ms"}
            if self._dropped:
                # Perfetto ignores unknown top-level keys; the count
                # keeps a truncated long run honest
                doc["nidtDroppedEvents"] = self._dropped
        try:
            d = os.path.dirname(out)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(out, "w") as f:
                json.dump(doc, f)
        except OSError:
            return None
        return out


#: the process-global tracer every instrumentation site records into
TRACER = SpanTracer()

#: module-level conveniences (the instrumentation-site spelling:
#: ``from neuroimagedisttraining_tpu_torch.obs import trace`` then
#: ``with trace.span("eval", round=r): ...``)
span = TRACER.span
instant = TRACER.instant
flow = TRACER.flow
arm = TRACER.arm
disarm = TRACER.disarm
dump = TRACER.dump
