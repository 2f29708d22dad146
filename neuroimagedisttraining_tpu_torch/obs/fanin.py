"""Telemetry fan-in across worker processes (the reference package's
``obs/fanin.py``).

The metrics registry, span buffer and flight ring are per process; a
fleet of spawned workers (the serving plane's ``serve/worker.py``) would
otherwise show the root only its own numbers. This module is the layer
between them:

- **worker side** (``WorkerObsShipper``): at most every
  ``OBS_SHIP_INTERVAL_S``, package the process's registry snapshot, the
  span buffer's NEW events (a capped chunk) and the flight ring's NEW
  events into one pipe payload, which rides the worker's pipe to the root
  as one ``("obs", ...)`` message beside its batched verdicts, never one
  a request.
- **root side** (``TelemetryFanIn``): keep each worker's LAST snapshot
  (and its age: a killed worker's numbers stay visible, marked stale),
  accumulate its spans and flight events, and render three merged
  artifacts:

  * ONE Prometheus exposition: the root registry's samples unchanged,
    every worker sample re-labeled ``worker="N"``, plus the synthesized
    ``nidt_obs_worker_snapshot_age_s`` / ``nidt_obs_worker_alive``
    staleness gauges;
  * ONE Chrome trace: root events as recorded, worker events rebased onto
    the root's clock by the spawn-time ping/pong handshake
    (``estimate_clock_offset``: offset = t_worker - midpoint(t0, t1),
    uncertainty = rtt/2), with ``process_name`` metadata a process so
    Perfetto lays workers out as tracks of their own;
  * ONE flight dump where every worker event carries ``worker``
    provenance, merged with the root ring in wall-clock order.

The upload-lifecycle stage histogram (``nidt_upload_stage_ms``) and the
client round-trip histogram (``nidt_client_rtt_ms``) are registered here
for the planes that observe them. Host code only: nothing here touches a
tensor.

Bounded by construction: span accumulation a worker is capped (dropped
counts surface in the merged trace's ``nidtDroppedEvents``), flight
accumulation is a deque ring, and one snapshot a worker is kept, never a
history.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
from typing import Any

from neuroimagedisttraining_tpu_torch.obs import flight as obs_flight
from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
from neuroimagedisttraining_tpu_torch.obs import names as N
from neuroimagedisttraining_tpu_torch.obs import trace as obs_trace
from neuroimagedisttraining_tpu_torch.obs.metrics import _escape, _fmt

__all__ = ["WorkerObsShipper", "TelemetryFanIn", "estimate_clock_offset",
           "suffixed_path", "stage_histogram", "rtt_histogram",
           "linked_flow_ids", "OBS_SHIP_INTERVAL_S", "UPLOAD_STAGES"]

log = logging.getLogger("neuroimagedisttraining_tpu_torch.obs")

#: how often a worker ships its telemetry payload over the pipe: one
#: message an interval a worker, NEVER one a request (the batching the
#: verdict events keep)
OBS_SHIP_INTERVAL_S = 0.5
#: span events per shipped chunk (a payload is one pickle over the
#: pipe; past the cap the chunk truncates and counts the drop)
SPAN_CHUNK_MAX = 4096
#: per-worker span accumulation cap at the root (the merged trace keeps
#: the PREFIX of each worker's timeline, the span buffer's own rule)
WORKER_SPAN_CAP = 1 << 16
#: per-worker flight ring at the root
WORKER_FLIGHT_CAP = 512

#: the upload lifecycle: queue/decode/admit/fold are per-UPLOAD stages
#: observed in an ingest worker process; merge/aggregate are
#: per-AGGREGATION stages observed at the root (they cover the whole
#: harvested buffer, not one upload).
UPLOAD_STAGES = ("queue", "decode", "admit", "fold", "merge", "aggregate")

#: ms buckets for the stage histogram (sub-ms decode up to multi-second
#: stalls)
STAGE_BUCKETS_MS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                    50.0, 100.0, 250.0, 1000.0)

#: ms buckets for the client-observed RTT histogram
RTT_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                  1000.0, 2500.0, 5000.0, 10000.0)


def stage_histogram(registry: obs_metrics.MetricsRegistry | None = None
                    ) -> obs_metrics.Histogram:
    """The per-stage upload-lifecycle latency histogram — registered
    idempotently in whichever process observes a stage."""
    reg = registry if registry is not None else obs_metrics.REGISTRY
    return reg.histogram(
        N.UPLOAD_STAGE_MS,
        "upload-lifecycle latency per stage (ms): queue/decode/admit/"
        "fold per upload in the worker, merge/aggregate per "
        "aggregation at the root",
        labelnames=("stage",), buckets=STAGE_BUCKETS_MS)


def rtt_histogram(registry: obs_metrics.MetricsRegistry | None = None
                  ) -> obs_metrics.Histogram:
    """Client-observed upload->sync round trip (ms), published by a load
    harness."""
    reg = registry if registry is not None else obs_metrics.REGISTRY
    return reg.histogram(
        N.CLIENT_RTT_MS,
        "client-observed upload->sync round-trip latency (ms), sampled "
        "by the load harness fleet",
        buckets=RTT_BUCKETS_MS)


def suffixed_path(path: str, wid: int) -> str:
    """Per-worker-process artifact path: ``trace.json`` -> \
``trace.w0.json`` (the root keeps the BARE path for the merged
    artifact, which is the primary one), so N worker processes given one
    ``--trace_out`` / ``--flight_out`` are not N writers of one file."""
    if not path:
        return ""
    root, ext = os.path.splitext(path)
    return f"{root}.w{int(wid)}{ext}" if ext else f"{path}.w{int(wid)}"


def estimate_clock_offset(t0_ns: int, t_worker_ns: int, t1_ns: int
                          ) -> tuple[int, int]:
    """Spawn-time clock handshake: the root sends its ``perf_counter``
    reading ``t0``, the worker replies with its own reading, the root
    receives at ``t1``. The worker's clock at the pipe's midpoint is
    the best estimate of "the same instant", so

        offset = t_worker - (t0 + t1) / 2      (worker clock − root)

    with uncertainty bounded by half the round trip. Returns
    ``(offset_ns, uncertainty_ns)``; a worker timestamp ``t_w`` maps to
    root time as ``t_w - offset``."""
    mid = (int(t0_ns) + int(t1_ns)) // 2
    return int(t_worker_ns) - mid, max(0, (int(t1_ns) - int(t0_ns)) // 2)


def linked_flow_ids(events: list[dict]) -> dict[str, set]:
    """Group flow-event ids by the phases seen: ``{"s": {...}, "t":
    {...}, "f": {...}, "linked": {...}}`` where ``linked`` holds ids
    with a start AND a step AND an end: a fully client->worker->root
    causally-linked upload."""
    by_phase: dict[str, set] = {"s": set(), "t": set(), "f": set()}
    for e in events:
        if e.get("ph") in by_phase and "id" in e:
            by_phase[e["ph"]].add(e["id"])
    by_phase["linked"] = by_phase["s"] & by_phase["t"] & by_phase["f"]
    return by_phase


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------


class WorkerObsShipper:
    """One worker process's telemetry packager. ``payload()`` returns a
    pipe-ready dict at most every ``interval_s`` (or always when
    ``force=True`` — the pre-bye final ship), containing the registry
    snapshot plus the span/flight events NEW since the last ship."""

    def __init__(self, interval_s: float = OBS_SHIP_INTERVAL_S,
                 registry: obs_metrics.MetricsRegistry | None = None,
                 tracer: obs_trace.SpanTracer | None = None,
                 flight: obs_flight.FlightRecorder | None = None,
                 span_chunk_max: int = SPAN_CHUNK_MAX):
        self.interval_s = float(interval_s)
        self.registry = (registry if registry is not None
                         else obs_metrics.REGISTRY)
        self.tracer = tracer if tracer is not None else obs_trace.TRACER
        self.flight = (flight if flight is not None
                       else obs_flight.FLIGHT)
        self.span_chunk_max = int(span_chunk_max)
        self._span_idx = 0
        self._flight_seq = 0
        self._last_ship = 0.0

    def payload(self, force: bool = False) -> dict | None:
        now = time.monotonic()
        if not force and now - self._last_ship < self.interval_s:
            return None
        self._last_ship = now
        spans: list[dict] = []
        spans_dropped = 0
        if self.tracer.armed:
            spans, self._span_idx = self.tracer.events_from(
                self._span_idx)
            if len(spans) > self.span_chunk_max:
                spans_dropped = len(spans) - self.span_chunk_max
                spans = spans[:self.span_chunk_max]
        fl, self._flight_seq = self.flight.events_from(self._flight_seq)
        return {
            "metrics": self.registry.snapshot(),
            "spans": spans,
            "spans_dropped": spans_dropped,
            "flight": fl,
            "epoch_ns": self.tracer.epoch_ns,
            "t_ns": time.perf_counter_ns(),
            "t_wall": time.time(),
            "pid": os.getpid(),
        }


# ---------------------------------------------------------------------------
# root side
# ---------------------------------------------------------------------------


class _WorkerTelemetry:
    """Per-worker accumulation at the root. ``wid`` is the fan-in KEY:
    a tuple with one element a label tier: ``(3,)`` on a flat root,
    ``(region, worker)`` under a hierarchical one."""

    __slots__ = ("wid", "alive", "pid", "offset_ns", "offset_err_ns",
                 "epoch_ns", "snapshot", "snap_mono", "snap_wall",
                 "spans", "spans_dropped", "flight", "flight_evicted")

    def __init__(self, wid: tuple):
        self.wid = tuple(wid)
        self.alive = True
        self.pid: int | None = None
        self.offset_ns = 0
        self.offset_err_ns: int | None = None
        self.epoch_ns: int | None = None
        self.snapshot: dict | None = None
        self.snap_mono: float | None = None
        self.snap_wall: float | None = None
        self.spans: list[dict] = []
        self.spans_dropped = 0
        self.flight: collections.deque = collections.deque(
            maxlen=WORKER_FLIGHT_CAP)
        self.flight_evicted = 0


class _MergedMetricsView:
    """Duck-typed registry for ``obs.http.MetricsServer``: a scrape of
    the merged exposition instead of one process's registry."""

    def __init__(self, fanin: "TelemetryFanIn"):
        self._fanin = fanin

    def prometheus_text(self) -> str:
        return self._fanin.prometheus_text()


class TelemetryFanIn:
    """The root's merge point. Thread-safe: the root's pipe drain calls
    ``ingest``/``note_clock``/``mark_dead`` while HTTP scrape threads
    call ``prometheus_text``; everything here takes only this object's
    own lock."""

    def __init__(self,
                 registry: obs_metrics.MetricsRegistry | None = None,
                 tracer: obs_trace.SpanTracer | None = None,
                 flight: obs_flight.FlightRecorder | None = None,
                 labelnames: tuple[str, ...] = ("worker",)):
        self._lock = threading.Lock()
        self._workers: dict[tuple, _WorkerTelemetry] = {}
        #: one label a key tier: ``("worker",)`` on a flat root,
        #: ``("region", "worker")`` under a hierarchical one; keys are
        #: same-length tuples, ints accepted as 1-tuples
        self.labelnames = tuple(labelnames)
        self.registry = (registry if registry is not None
                         else obs_metrics.REGISTRY)
        self.tracer = tracer if tracer is not None else obs_trace.TRACER
        self.flight = (flight if flight is not None
                       else obs_flight.FLIGHT)

    # ---- key helpers ----

    def _key(self, wid) -> tuple:
        if isinstance(wid, tuple):
            return tuple(int(x) for x in wid)
        return (int(wid),)

    def _labels(self, key: tuple) -> dict[str, str]:
        return {n: str(v) for n, v in zip(self.labelnames, key)}

    def _name(self, key: tuple) -> str:
        return (str(key[0]) if len(key) == 1
                else "/".join(str(v) for v in key))

    # ---- worker lifecycle / ingestion ----

    def register_worker(self, wid) -> None:
        key = self._key(wid)
        with self._lock:
            self._workers.setdefault(key, _WorkerTelemetry(key))

    def note_clock(self, wid, t0_ns: int, t_worker_ns: int,
                   t1_ns: int) -> None:
        off, err = estimate_clock_offset(t0_ns, t_worker_ns, t1_ns)
        key = self._key(wid)
        with self._lock:
            w = self._workers.setdefault(key, _WorkerTelemetry(key))
            w.offset_ns, w.offset_err_ns = off, err

    def mark_dead(self, wid) -> None:
        """A dead worker's LAST snapshot stays visible — the staleness
        gauge, not deletion, is how its death reads on a scrape. A key
        PREFIX shorter than the label tiers marks the whole subtree
        (a dead REGION marks every ``(region, *)`` worker)."""
        key = self._key(wid)
        with self._lock:
            if len(key) < len(self.labelnames):
                for k, w in self._workers.items():
                    if k[:len(key)] == key:
                        w.alive = False
                return
            w = self._workers.get(key)
            if w is not None:
                w.alive = False

    def ingest(self, wid, payload: dict) -> None:
        """One ``("obs", wid, payload)`` pipe message."""
        key = self._key(wid)
        with self._lock:
            w = self._workers.setdefault(key, _WorkerTelemetry(key))
            snap = payload.get("metrics")
            if snap is not None:
                w.snapshot = snap
                w.snap_mono = time.monotonic()
                w.snap_wall = payload.get("t_wall", time.time())
            if payload.get("pid"):
                w.pid = int(payload["pid"])
            if payload.get("epoch_ns") is not None:
                w.epoch_ns = int(payload["epoch_ns"])
            spans = payload.get("spans") or []
            room = WORKER_SPAN_CAP - len(w.spans)
            if len(spans) > room:
                w.spans_dropped += len(spans) - max(0, room)
                spans = spans[:max(0, room)]
            w.spans.extend(spans)
            w.spans_dropped += int(payload.get("spans_dropped") or 0)
            for ev in payload.get("flight") or ():
                if len(w.flight) == w.flight.maxlen:
                    w.flight_evicted += 1
                w.flight.append(ev)

    def summary(self) -> dict:
        """Machine-readable fan-in state (the root's ``/healthz``)."""
        with self._lock:
            now = time.monotonic()
            return {self._name(w.wid): {
                "alive": w.alive,
                "has_metrics": w.snapshot is not None,
                "snapshot_age_s": (round(now - w.snap_mono, 3)
                                   if w.snap_mono is not None else None),
                "spans": len(w.spans),
                "flight_events": len(w.flight),
                "clock_offset_ns": w.offset_ns,
                "clock_uncertainty_ns": w.offset_err_ns,
            } for w in self._workers.values()}

    def metrics_view(self) -> _MergedMetricsView:
        return _MergedMetricsView(self)

    def merged_snapshot(self) -> dict:
        """Snapshot-form merge (the ``registry.snapshot()`` schema):
        root cells unchanged, worker cells re-labeled with
        ``worker="N"``: what the anomaly-rule engine (obs/rules.py)
        evaluates on a sharded root, so a rule's label-subset selector
        fires on a WORKER's labeled series exactly as it would on a
        local one."""
        merged: dict[str, dict] = {}

        def _fold(snapshot: dict, extra: dict[str, str]) -> None:
            for name, m in snapshot.items():
                slot = merged.setdefault(
                    name, {"kind": m["kind"], "help": m["help"],
                           "values": []})
                if slot["kind"] != m["kind"]:
                    continue  # version skew — same rule as the text merge
                for v in m["values"]:
                    slot["values"].append(
                        {"labels": {**v["labels"], **extra},
                         "value": v["value"]})

        _fold(self.registry.snapshot(), {})
        with self._lock:
            for w in self._workers.values():
                if w.snapshot is not None:
                    _fold(w.snapshot, self._labels(w.wid))
        return merged

    # ---- merged Prometheus exposition ----

    def prometheus_text(self) -> str:
        """ONE exposition: root samples unchanged, worker samples with
        a ``worker`` label, one HELP/TYPE block per metric name, plus
        the synthesized worker-staleness gauges."""
        merged: dict[str, dict] = {}

        def _fold(snapshot: dict, extra: dict[str, str]) -> None:
            for name, m in snapshot.items():
                slot = merged.setdefault(
                    name, {"kind": m["kind"], "help": m["help"],
                           "rows": []})
                if slot["kind"] != m["kind"]:
                    # same codebase on both ends — a mismatch means
                    # version skew; skip rather than emit invalid text
                    log.warning("fanin: metric %s kind mismatch (%s vs "
                                "%s); skipping one source", name,
                                slot["kind"], m["kind"])
                    continue
                for v in m["values"]:
                    slot["rows"].append(({**v["labels"], **extra},
                                         v["value"]))

        _fold(self.registry.snapshot(), {})
        with self._lock:
            workers = list(self._workers.values())
            for w in workers:
                if w.snapshot is not None:
                    _fold(w.snapshot, self._labels(w.wid))
            # synthesized staleness plane: how old each worker's last
            # snapshot is (a SIGKILLed worker's age grows forever) and
            # whether the root still believes the process alive
            now = time.monotonic()
            age_rows = [(self._labels(w.wid),
                         round(now - w.snap_mono, 3))
                        for w in workers if w.snap_mono is not None]
            alive_rows = [(self._labels(w.wid), 1.0 if w.alive
                           else 0.0) for w in workers]
        if age_rows:
            merged[N.OBS_WORKER_SNAPSHOT_AGE] = {
                "kind": "gauge",
                "help": "seconds since this worker's last telemetry "
                        "snapshot reached the root (stale = dead or "
                        "wedged worker)",
                "rows": age_rows}
        if alive_rows:
            merged[N.OBS_WORKER_ALIVE] = {
                "kind": "gauge",
                "help": "1 while the root believes the worker process "
                        "is alive",
                "rows": alive_rows}
        lines: list[str] = []
        for name in sorted(merged):
            m = merged[name]
            if m["help"]:
                lines.append(f"# HELP {name} {m['help']}")
            lines.append(f"# TYPE {name} {m['kind']}")
            for labels, value in m["rows"]:
                lines.extend(_render_sample(name, m["kind"], labels,
                                            value))
        return "\n".join(lines) + "\n"

    # ---- merged Chrome trace ----

    def merged_trace_events(self) -> list[dict]:
        """Root events as recorded; worker events rebased onto the
        root's clock: a worker event at ``ts`` µs past its epoch
        happened at absolute worker-clock ``epoch_w + ts``, which is
        root-clock ``epoch_w + ts - offset``, i.e. root-relative
        ``ts + (epoch_w - offset - epoch_root)``."""
        events = list(self.tracer.events())
        root_pid = os.getpid()
        meta = [{"name": "process_name", "ph": "M", "pid": root_pid,
                 "tid": 0, "args": {"name": "ingest-root"}}]
        root_epoch = self.tracer.epoch_ns
        with self._lock:
            for w in self._workers.values():
                if not w.spans:
                    continue
                shift_us = ((int(w.epoch_ns or root_epoch)
                             - int(w.offset_ns) - root_epoch) / 1e3)
                pid = w.pid
                for e in w.spans:
                    e2 = dict(e)
                    e2["ts"] = float(e.get("ts", 0.0)) + shift_us
                    events.append(e2)
                    if pid is None:
                        pid = e.get("pid")
                if pid is not None:
                    if len(w.wid) == 1:
                        pname = f"ingest-worker-{w.wid[0]}"
                    else:
                        pname = "ingest-" + "-".join(
                            f"{n}{v}" for n, v in
                            zip(self.labelnames, w.wid))
                    meta.append({"name": "process_name", "ph": "M",
                                 "pid": pid, "tid": 0,
                                 "args": {"name": pname}})
        return meta + events

    def merged_trace_doc(self) -> dict:
        doc = {"traceEvents": self.merged_trace_events(),
               "displayTimeUnit": "ms"}
        with self._lock:
            dropped = sum(w.spans_dropped
                          for w in self._workers.values())
        if dropped:
            doc["nidtDroppedEvents"] = dropped
        return doc

    def dump_trace(self, path: str) -> str | None:
        """Write the MERGED Chrome trace (the primary ``--trace_out``
        artifact of a worker fleet; per-worker local dumps are the
        ``.wN``-suffixed secondaries). Same never-crash contract as
        ``SpanTracer.dump``."""
        if not path:
            return None
        doc = self.merged_trace_doc()
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f)
        except OSError:
            return None
        return path

    # ---- merged flight dump ----

    def merged_flight_doc(self, reason: str = "") -> dict:
        """Root ring events with ``proc: "root"``, worker events with
        ``proc: "worker<N>"`` + ``worker`` provenance, ordered by wall
        clock (the cross-process join key both rings record)."""
        events = [{**e, "proc": "root"} for e in self.flight.events()]
        with self._lock:
            for w in self._workers.values():
                if len(w.wid) == 1:
                    tag, prov = f"worker{w.wid[0]}", {"worker": w.wid[0]}
                else:
                    tag = "-".join(f"{n}{v}" for n, v in
                                   zip(self.labelnames, w.wid))
                    prov = {n: v for n, v in
                            zip(self.labelnames, w.wid)}
                events.extend({**e, "proc": tag, **prov}
                              for e in w.flight)
            workers = {self._name(w.wid): {"alive": w.alive,
                                           "events": len(w.flight),
                                           "evicted": w.flight_evicted}
                       for w in self._workers.values()}
            evicted = sum(w.flight_evicted
                          for w in self._workers.values())
        events.sort(key=lambda e: e.get("t_wall", 0.0))
        # bounded-ring honesty carried forward: the root ring's own
        # eviction count plus every per-worker accumulation drop — a
        # reader must never believe a truncated merge is complete
        return {"reason": reason, "capacity": self.flight.capacity,
                "evicted": self.flight.evicted + evicted,
                "workers": workers, "events": events}

    def dump_flight(self, path: str, reason: str = "") -> str | None:
        if not path:
            return None
        doc = self.merged_flight_doc(reason=reason)
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f, default=str)
        except OSError:
            return None
        return path


def _render_sample(name: str, kind: str, labels: dict,
                   value: Any) -> list[str]:
    """Exposition lines for one sample from SNAPSHOT form. Histogram
    snapshot buckets are per-bucket counts keyed by formatted upper
    bound — rendered here as the CUMULATIVE ``_bucket`` series plus
    ``_sum``/``_count`` (Prometheus histogram semantics, matching
    ``Histogram._expose``)."""

    def label_str(extra: str = "") -> str:
        parts = [f'{k}="{_escape(v)}"'
                 for k, v in sorted(labels.items())]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    if kind != "histogram":
        return [f"{name}{label_str()} {_fmt(value)}"]
    buckets = dict(value.get("buckets", {}))
    inf = buckets.pop("+Inf", 0)
    out, acc = [], 0
    for le in sorted(buckets, key=float):
        acc += int(buckets[le])
        le_attr = 'le="' + str(le) + '"'
        out.append(f"{name}_bucket{label_str(le_attr)} {acc}")
    inf_attr = 'le="+Inf"'
    out.append(f"{name}_bucket{label_str(inf_attr)} "
               f"{int(value.get('count', acc + inf))}")
    out.append(f"{name}_sum{label_str()} {_fmt(value.get('sum', 0.0))}")
    out.append(f"{name}_count{label_str()} {int(value.get('count', 0))}")
    return out
