"""Root of the sharded serving plane (the reference package's
``serve/server.py``).

Spawns ``serve_workers`` HTTP worker processes on ONE ``SO_REUSEPORT``
port (the spawn / ready / clock handshake), accumulates their batched
admission verdicts into per-worker root counters, fans their telemetry
into one merged ``/metrics`` exposition and trace / flight artifacts
(``obs/fanin.py``), and audits at shutdown: each live worker's bye totals
must equal the root's accumulated verdict batches, so a request lands only
in a verdict or in a client-seen transport error, never nowhere. A killed
worker is marked dead and its unflushed tail (bounded by the flush
cadence) is reported as ``dead_workers``, not reconciled.

The workers are spawned (``mp.get_context("spawn")``): a forked child of a
parent that holds a CUDA context could not use the card. Each worker gets
the root's ``device`` in its config and makes its own context on it.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
import socket
import threading
import time

from neuroimagedisttraining_tpu_torch.obs import fanin as obs_fanin
from neuroimagedisttraining_tpu_torch.obs import flight as obs_flight
from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
from neuroimagedisttraining_tpu_torch.obs import names as obs_names
from neuroimagedisttraining_tpu_torch.obs import trace as obs_trace
from neuroimagedisttraining_tpu_torch.serve.bundle import read_manifest
from neuroimagedisttraining_tpu_torch.serve.worker import (
    MAX_BODY_BYTES,
    VERDICTS,
    _serve_worker_main,
)

log = logging.getLogger("neuroimagedisttraining_tpu_torch.serve")


class ShardedServeServer:
    """N SO_REUSEPORT HTTP workers + the auditing, fanning-in root; the
    workers serve on ``device`` (``"cuda"`` unless the caller asks for the
    CPU)."""

    def __init__(self, bundle_path: str, *, port: int = 0,
                 serve_workers: int = 2,
                 batch_buckets: tuple[int, ...] = (1, 2, 4, 8),
                 max_queue_ms: float = 2.0, precision: str = "",
                 max_body: int = MAX_BODY_BYTES,
                 spawn_timeout: float = 180.0, trace_out: str = "",
                 flight_out: str = "", device: str = "cuda"):
        if serve_workers < 1:
            raise ValueError(
                f"serve_workers must be >= 1, got {serve_workers}")
        # fail fast on a broken bundle at the ROOT (schema/version
        # checks); each worker then does the full sha256/digest
        # verification on its own load
        self.manifest = read_manifest(bundle_path)
        self.serve_workers = int(serve_workers)
        self.trace_out = trace_out
        self.flight_out = flight_out
        self._lock = threading.Lock()
        self._verdicts: dict[str, int] = {}
        self._obs_workers_live = obs_metrics.gauge(
            obs_names.SERVE_WORKERS_LIVE,
            "serve worker processes alive")
        self._obs_worker_requests = obs_metrics.counter(
            obs_names.SERVE_WORKER_REQUESTS,
            "per-worker admission verdict events at the serve root",
            labelnames=("worker", "outcome"))
        self.fanin = obs_fanin.TelemetryFanIn()
        self._obs_dumped = False

        # reserve the shared port: bound (never listening) with
        # SO_REUSEPORT so the workers can bind+listen the same number;
        # a non-listening TCP socket receives no connections
        self._port_holder = socket.socket(socket.AF_INET,
                                          socket.SOCK_STREAM)
        self._port_holder.setsockopt(socket.SOL_SOCKET,
                                     socket.SO_REUSEPORT, 1)
        self._port_holder.bind(("0.0.0.0", int(port or 0)))
        self.port = self._port_holder.getsockname()[1]

        ctx = mp.get_context("spawn")
        wcfg = {
            "bundle": os.path.abspath(bundle_path),
            "port": self.port,
            "batch_buckets": tuple(int(b) for b in batch_buckets),
            "max_queue_ms": float(max_queue_ms),
            "precision": precision,
            "max_body": int(max_body),
            "device": str(device),
            "obs": {"trace": bool(trace_out) or obs_trace.TRACER.armed,
                    "trace_path": trace_out,
                    "flight_path": flight_out,
                    "flight_capacity": obs_flight.FLIGHT.capacity},
        }
        self._workers: dict[int, dict] = {}
        for wid in range(self.serve_workers):
            parent, child = ctx.Pipe(duplex=True)
            proc = ctx.Process(target=_serve_worker_main,
                               args=(wid, child, wcfg), daemon=True,
                               name=f"nidt-serve-w{wid}")
            proc.start()
            child.close()
            self._workers[wid] = {
                "proc": proc, "conn": parent, "alive": True,
                "verdicts": {}, "bye": None,
            }
        deadline = time.monotonic() + spawn_timeout
        ready: set[int] = set()
        while len(ready) < self.serve_workers:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._kill_workers()
                raise RuntimeError(
                    f"serve workers not ready within {spawn_timeout}s "
                    f"({sorted(ready)} of {self.serve_workers})")
            for wid, w in self._workers.items():
                if wid in ready:
                    continue
                try:
                    if w["conn"].poll(0.05):
                        msg = w["conn"].recv()
                        if msg[0] == "ready":
                            ready.add(wid)
                        else:
                            self._handle_event(wid, msg)
                except (EOFError, OSError) as e:
                    # a worker dead during spawn (bundle drift, bind
                    # failure, import error) is a NAMED startup
                    # failure, with no orphan siblings left running
                    self._kill_workers()
                    raise RuntimeError(
                        f"serve worker {wid} died during startup "
                        f"({type(e).__name__}); see its log output"
                    ) from e
        self._obs_workers_live.set(self.serve_workers)
        # spawn-time clock handshake (obs/fanin.py): collected HERE so
        # a reply aging in the pipe never inflates the offset estimate
        for wid, w in self._workers.items():
            self.fanin.register_worker(wid)
            try:
                # the ctor is single-threaded: the drain thread does
                # not exist yet
                w["conn"].send(("clock", time.perf_counter_ns()))
            except (BrokenPipeError, OSError):
                pass
        pending = set(self._workers)
        clock_deadline = time.monotonic() + 2.0
        while pending and time.monotonic() < clock_deadline:
            for wid in sorted(pending):
                w = self._workers[wid]
                try:
                    while w["conn"].poll(0.02):
                        ev = w["conn"].recv()
                        self._handle_event(wid, ev)
                        if ev[0] == "clock_reply":
                            pending.discard(wid)
                            break
                except (EOFError, OSError):
                    pending.discard(wid)  # death surfaces in the drain
        if pending:
            log.warning("serve root: no clock reply from workers %s "
                        "within 2s; their merged-trace timelines fall "
                        "back to offset 0", sorted(pending))
        self._stop = threading.Event()
        self._drain_thread = threading.Thread(target=self._drain_loop,
                                              daemon=True,
                                              name="serve-root-drain")
        self._drain_thread.start()
        log.info("serve root: %d workers ready on port %d (model %s "
                 "round %d, %d site models)", self.serve_workers,
                 self.port, self.manifest["model"],
                 self.manifest["source_round"],
                 len(self.manifest["sites"]))

    # ---- pipe events ----

    def _handle_event(self, wid: int, ev: tuple) -> None:
        kind = ev[0]
        w = self._workers[wid]
        if kind == "vb":
            counts = ev[2]
            with self._lock:
                for outcome, n in counts.items():
                    w["verdicts"][outcome] = \
                        w["verdicts"].get(outcome, 0) + n
                    self._verdicts[outcome] = \
                        self._verdicts.get(outcome, 0) + n
            for outcome, n in counts.items():
                self._obs_worker_requests.labels(
                    worker=str(wid), outcome=outcome).inc(n)
        elif kind == "obs":
            self.fanin.ingest(wid, ev[2])
        elif kind == "clock_reply":
            self.fanin.note_clock(wid, ev[2], ev[3],
                                  time.perf_counter_ns())
        elif kind == "bye":
            with self._lock:
                w["bye"] = ev[2]

    def _drain_loop(self) -> None:
        while not self._stop.is_set():
            busy = False
            for wid, w in self._workers.items():
                if not w["alive"]:
                    continue
                try:
                    while w["conn"].poll(0):
                        self._handle_event(wid, w["conn"].recv())
                        busy = True
                except (EOFError, OSError):
                    self._mark_dead(wid)
            if not busy:
                time.sleep(0.02)

    def _mark_dead(self, wid: int) -> None:
        w = self._workers[wid]
        if not w["alive"]:
            return
        w["alive"] = False
        self.fanin.mark_dead(wid)
        self._obs_workers_live.set(len(self.live_workers()))
        obs_flight.record("serve_worker_dead", worker=wid)
        log.warning("serve root: worker %d died (pipe closed); "
                    "%d listeners remain on port %d", wid,
                    len(self.live_workers()), self.port)

    # ---- introspection ----

    @property
    def worker_pids(self) -> list[int]:
        return [w["proc"].pid for w in self._workers.values()]

    def live_workers(self) -> list[int]:
        return [wid for wid, w in self._workers.items() if w["alive"]]

    def total(self, outcome: str) -> int:
        with self._lock:
            return self._verdicts.get(outcome, 0)

    def metrics_view(self):
        """The MERGED registry view for the root ``--metrics_port``
        exposition: root samples + worker samples (``worker`` label) +
        snapshot-staleness gauges (obs/fanin.py)."""
        return self.fanin.metrics_view()

    def health(self) -> dict:
        """Root ``/healthz`` probe payload (obs.http.MetricsServer)."""
        live = self.live_workers()
        with self._lock:
            verdicts = dict(self._verdicts)
        return {
            "ok": bool(live),
            "serve": {
                "model": self.manifest["model"],
                "model_version": self.manifest["source_round"],
                "bundle_sha256": self.manifest["weights_sha256"],
                "sites": len(self.manifest["sites"]),
                "workers_live": len(live),
                "workers": self.serve_workers,
                "port": self.port,
                "verdicts": verdicts,
            },
            "fanin": self.fanin.summary(),
        }

    def audit(self) -> dict:
        """Shutdown reconciliation: per live worker, the bye totals
        must EQUAL the root's accumulated verdict batches (the pipe
        lost nothing); a dead worker's tail since its last flush is
        unknowable and reported, not hidden."""
        with self._lock:
            per_worker = {}
            reconciled = True
            lost_with_worker = 0
            for wid, w in self._workers.items():
                bye = w["bye"]
                root_counts = {k: v for k, v in w["verdicts"].items()
                               if v}
                if bye is not None:
                    bye_counts = {k: v for k, v in bye.items()
                                  if k != "engine" and v}
                    ok = bye_counts == root_counts
                    reconciled = reconciled and ok
                else:
                    bye_counts = None
                    ok = False
                    if w["alive"]:
                        reconciled = False
                    else:
                        # SIGKILLed worker: its post-flush tail is
                        # gone; root counts stand as the lower bound
                        lost_with_worker += 1
                per_worker[str(wid)] = {
                    "alive": w["alive"], "root": root_counts,
                    "bye": bye_counts, "reconciled": ok,
                    "engine": (bye.get("engine")
                               if bye is not None else None),
                }
            totals = dict(self._verdicts)
        received = sum(totals.get(v, 0) for v in VERDICTS)
        return {
            "received": received,
            "served": totals.get("served", 0),
            "rejected": sum(totals.get(v, 0) for v in VERDICTS
                            if v.startswith("rejected")),
            "errors": totals.get("error", 0),
            "unknown_site": totals.get("unknown_site", 0),
            "per_worker": per_worker,
            "dead_workers": lost_with_worker,
            "reconciled": reconciled,
        }

    def dump_obs(self, reason: str = "end of run"
                 ) -> dict[str, str | None]:
        """Merged trace/flight artifacts at the bare configured paths
        (idempotent); workers write ``.wN``-suffixed secondaries."""
        with self._lock:
            if self._obs_dumped:
                return {}
            self._obs_dumped = True
        out: dict[str, str | None] = {}
        if self.trace_out:
            out["trace"] = self.fanin.dump_trace(self.trace_out)
        if self.flight_out:
            out["flight"] = self.fanin.dump_flight(self.flight_out,
                                                   reason=reason)
        return out

    # ---- shutdown ----

    def stop(self, timeout: float = 15.0) -> dict:
        """Finish the fleet: ask each live worker to flush+bye, wait
        for the byes (the drain thread ingests them), then join/kill
        and return the audit."""
        for wid, w in self._workers.items():
            if not w["alive"]:
                continue
            try:
                w["conn"].send(("finish",))
            except (BrokenPipeError, OSError):
                self._mark_dead(wid)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                waiting = [wid for wid, w in self._workers.items()
                           if w["alive"] and w["bye"] is None]
            if not waiting:
                break
            time.sleep(0.05)
        self._stop.set()
        self._drain_thread.join(timeout=5.0)
        for w in self._workers.values():
            w["proc"].join(timeout=5.0)
            if w["proc"].is_alive():
                w["proc"].kill()
                w["proc"].join(timeout=5.0)
        self._port_holder.close()
        self._obs_workers_live.set(0)
        self.dump_obs()
        return self.audit()

    def _kill_workers(self) -> None:
        for w in self._workers.values():
            if w["proc"].is_alive():
                w["proc"].kill()
            w["proc"].join(timeout=5.0)
        self._port_holder.close()
