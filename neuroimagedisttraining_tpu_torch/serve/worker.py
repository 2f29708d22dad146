"""One serving worker process (the reference package's
``serve/worker.py``).

N spawned worker processes all listen on ONE ``SO_REUSEPORT`` port with a
stdlib ``ThreadingHTTPServer`` speaking ``/predict``, and talk to the root
over one duplex pipe: ``("ready", wid)``, batched ``("vb", wid, counts)``
admission verdicts, rate-limited ``("obs", wid, payload)`` telemetry
(``obs/fanin.py``), clock echoes, and a final ``("bye", wid, stats)``
whose counts the root audits against the verdict batches it accumulated.

Each worker loads the bundle itself and runs its own :class:`ServeEngine`
on the device its config names (``"device"``, from the root): on ``cuda``
it makes its own CUDA context on the card and captures its own graphs; it
never picks the CPU on its own. The request threads do no CUDA work: they
parse, queue and wait, and the engine's batcher thread alone touches the
card.

Admission is flight-recorded: malformed / oversized / unknown-site
verdicts land in the flight ring with the peer address. ``/metrics`` and
``/healthz`` (model version, last-dispatch age, queue depth, rule-engine
status) are served a worker; the root fans the registries in.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from neuroimagedisttraining_tpu_torch.obs import compute as obs_compute
from neuroimagedisttraining_tpu_torch.obs import fanin as obs_fanin
from neuroimagedisttraining_tpu_torch.obs import flight as obs_flight
from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
from neuroimagedisttraining_tpu_torch.obs import names as obs_names
from neuroimagedisttraining_tpu_torch.obs import rules as obs_rules
from neuroimagedisttraining_tpu_torch.obs import trace as obs_trace
from neuroimagedisttraining_tpu_torch.serve.bundle import load_bundle
from neuroimagedisttraining_tpu_torch.serve.engine import (
    ServeEngine,
    serve_latency_histogram,
)

log = logging.getLogger("neuroimagedisttraining_tpu_torch.serve")

#: request-body ceiling; a flagship 121x145x121 float32 volume is
#: 8,491,780 bytes as a raw body (as JSON text it does not fit)
MAX_BODY_BYTES = 16 << 20

#: verdict-batch flush cadence over the root pipe: one pipe message a
#: batch, never one a request
_VB_AGE_S = 0.05
_VB_MAX = 256

#: admission verdict names (the ``outcome`` label set)
VERDICTS = ("served", "rejected_malformed", "rejected_oversized",
            "error")


class _ReuseportHTTPServer(ThreadingHTTPServer):
    """Stdlib HTTP on a shared port: SO_REUSEPORT before bind, so the
    kernel balances accepted connections across the worker fleet."""

    daemon_threads = True
    allow_reuse_address = True

    def server_bind(self):
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()


class _ServeWorkerProc:
    """One worker process: the HTTP listener + engine + root pipe."""

    def __init__(self, wid: int, engine: ServeEngine, conn, port: int,
                 max_body: int = MAX_BODY_BYTES):
        self.wid = wid
        self.engine = engine
        self.conn = conn
        self.max_body = int(max_body)
        self._lock = threading.Lock()
        #: verdict batch (under _lock): counts per outcome, ONE "vb"
        #: pipe message per batch (size/age/pre-bye flush)
        self._vb_counts: dict[str, int] = {}
        self._vb_n = 0
        #: lifetime totals (under _lock) — the bye payload the root
        #: audits its accumulated batches against
        self._totals: dict[str, int] = {v: 0 for v in VERDICTS}
        self._totals["unknown_site"] = 0
        self._shipper = obs_fanin.WorkerObsShipper()
        self._requests = obs_metrics.counter(
            obs_names.SERVE_REQUESTS,
            "admission verdicts on the serving path (serve/worker.py)",
            labelnames=("outcome",))
        self._lat = serve_latency_histogram()
        self._done = threading.Event()
        self._bye_sent = threading.Event()
        self.httpd = _ReuseportHTTPServer(("0.0.0.0", port),
                                          _make_handler(self))
        self._pipe_thread = threading.Thread(target=self._pipe_loop,
                                             daemon=True,
                                             name=f"serve-w{wid}-pipe")

    # ---- admission bookkeeping (handler threads) ----

    def note_verdict(self, outcome: str, unknown_site: bool = False
                     ) -> None:
        self._requests.labels(outcome=outcome).inc()
        if unknown_site:
            self._requests.labels(outcome="unknown_site").inc()
        with self._lock:
            self._totals[outcome] += 1
            self._vb_counts[outcome] = self._vb_counts.get(outcome, 0) + 1
            if unknown_site:
                self._totals["unknown_site"] += 1
                self._vb_counts["unknown_site"] = \
                    self._vb_counts.get("unknown_site", 0) + 1
            self._vb_n += 1
            if self._vb_n >= _VB_MAX:
                self._flush_verdicts_locked()

    def _flush_verdicts_locked(self) -> None:
        if not self._vb_n:
            return
        # every caller holds self._lock (the _locked suffix contract); the
        # one pipe has no other writer thread outside it
        self.conn.send(("vb", self.wid, self._vb_counts))
        self._vb_counts, self._vb_n = {}, 0

    def _ship_obs_locked(self, force: bool = False) -> None:
        payload = self._shipper.payload(force=force)
        if payload is not None:
            # the caller holds self._lock (the _locked suffix contract)
            self.conn.send(("obs", self.wid, payload))

    # ---- lifecycle ----

    def run(self) -> None:
        self._pipe_thread.start()
        with self._lock:
            self.conn.send(("ready", self.wid))
        try:
            self.httpd.serve_forever(poll_interval=0.1)
        finally:
            self.httpd.server_close()
            if self._done.is_set():
                # the pipe thread is mid-_finish: hold the process
                # open until the bye is on the wire (a daemon thread
                # dies with the main thread)
                self._bye_sent.wait(timeout=20.0)

    def _pipe_loop(self) -> None:
        while True:
            try:
                if not self.conn.poll(_VB_AGE_S):
                    # quiet tick: age out a partial verdict batch; the
                    # shipper rate-limits the telemetry payload itself
                    with self._lock:
                        self._flush_verdicts_locked()
                        self._ship_obs_locked()
                    continue
                cmd = self.conn.recv()
            except (EOFError, OSError):
                log.warning("serve worker %d: root pipe closed; "
                            "shutting down", self.wid)
                self.httpd.shutdown()
                return
            kind = cmd[0]
            if kind == "clock":
                with self._lock:
                    self.conn.send(("clock_reply", self.wid, cmd[1],
                                    time.perf_counter_ns()))
            elif kind == "finish":
                self._finish()
                return

    def _finish(self) -> None:
        self._done.set()
        # stop accepting; in-flight handler threads finish their
        # replies before the engine closes below (predict blocks, so
        # give the tail a short drain)
        self.httpd.shutdown()
        deadline = time.monotonic() + 2.0
        while self.engine.queue_depth() and time.monotonic() < deadline:
            time.sleep(0.02)
        # dispatches are done; give reply threads a beat to record
        # their verdicts before the bye snapshot
        time.sleep(0.1)
        self.engine.close()
        with self._lock:
            self._flush_verdicts_locked()
            obs_flight.record("serve_worker_finish", worker=self.wid,
                              served=self._totals["served"])
            # final telemetry ship BEFORE the bye (same pipe, FIFO) so
            # the root's merged artifacts include this worker's tail
            self._ship_obs_locked(force=True)
            stats = dict(self._totals)
            stats["engine"] = self.engine.stats()
            self.conn.send(("bye", self.wid, stats))
        obs_trace.dump()
        self._bye_sent.set()


def _make_handler(proc: _ServeWorkerProc):
    engine = proc.engine
    bundle = engine.bundle
    known_sites = set(bundle.sites)

    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # stdlib default writes stderr
            pass

        def _reply(self, code: int, body: bytes,
                   ctype: str = "application/json",
                   close: bool = False) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if close:
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(body)

        def _reject(self, code: int, outcome: str, reason: str,
                    close: bool = False) -> None:
            obs_flight.record("serve_reject", worker=proc.wid,
                              outcome=outcome, reason=reason,
                              peer=self.client_address[0])
            proc.note_verdict(outcome)
            self._reply(code, json.dumps({"error": reason}).encode(),
                        close=close)

        # ---- /predict ----

        def do_POST(self) -> None:
            if self.path != "/predict":
                self._reply(404, b'{"error": "unknown path"}')
                return
            try:
                length = int(self.headers.get("Content-Length", ""))
                if length < 0:
                    raise ValueError("negative length")
            except ValueError:
                self._reject(411, "rejected_malformed",
                             "Content-Length required", close=True)
                return
            if length > proc.max_body:
                # refuse WITHOUT reading the body; the connection is
                # unusable past an unread body, so close it
                self._reject(413, "rejected_oversized",
                             f"body {length} > max {proc.max_body}",
                             close=True)
                return
            body = self.rfile.read(length)
            site: str | None = None
            try:
                ctype = (self.headers.get("Content-Type") or "").split(
                    ";")[0].strip()
                if ctype == "application/json":
                    obj = json.loads(body)
                    if "site" in obj and obj["site"] is not None:
                        site = str(obj["site"])
                    x = np.asarray(obj["x"], dtype=np.float32)
                else:
                    # raw little-endian f32 array; shape and site ride
                    # headers
                    shape = tuple(
                        int(d) for d in
                        (self.headers.get("X-NIDT-Shape") or "").split(
                            ",") if d)
                    site = self.headers.get("X-NIDT-Site") or None
                    x = np.frombuffer(body, dtype="<f4").reshape(shape)
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._reject(400, "rejected_malformed",
                             f"bad request body: {e}")
                return
            unknown = site is not None and site not in known_sites
            if unknown:
                obs_flight.record("serve_unknown_site", worker=proc.wid,
                                  site=site,
                                  peer=self.client_address[0])
            try:
                pending, model_key = engine.submit(site, x)
            except ValueError as e:
                self._reject(400, "rejected_malformed", str(e))
                return
            except RuntimeError as e:  # engine closed (finish race)
                self._reject(503, "error", str(e), close=True)
                return
            if not pending.event.wait(30.0):
                self._reject(504, "error", "dispatch timeout")
                return
            t_result = time.perf_counter()
            if pending.error is not None:
                self._reject(500, "error",
                             f"dispatch failed: {pending.error}")
                return
            out = {
                "y": np.asarray(pending.result, np.float64).tolist(),
                "model": model_key,
                "digest": bundle.digest(model_key),
                "model_version": bundle.source_round,
                "worker": proc.wid,
            }
            self._reply(200, json.dumps(out).encode())
            proc._lat.labels(stage="reply").observe(
                (time.perf_counter() - t_result) * 1e3)
            proc.note_verdict("served", unknown_site=unknown)

        # ---- /metrics + /healthz ----

        def do_GET(self) -> None:
            if self.path == "/metrics":
                self._reply(200,
                            obs_metrics.REGISTRY.prometheus_text(
                            ).encode(),
                            ctype="text/plain; version=0.0.4")
            elif self.path == "/healthz":
                rules_block = obs_rules.health_block()
                ok = rules_block.get("status") != "critical"
                body = {
                    "ok": ok,
                    "worker": proc.wid,
                    "model": bundle.model_name,
                    "model_version": bundle.source_round,
                    "bundle_sha256": bundle.manifest["weights_sha256"],
                    "precision": engine.precision,
                    "queue_depth": engine.queue_depth(),
                    "compute": obs_compute.health(),
                    "health": rules_block,
                }
                self._reply(200 if ok else 503,
                            json.dumps(obs_metrics._json_safe(body)
                                       ).encode())
            else:
                self._reply(404, b'{"error": "unknown path"}')

    return _Handler


def _serve_worker_main(wid: int, conn, wcfg: dict) -> None:
    """Spawned worker entry point ('spawn' context: a fresh interpreter,
    obs registry and CUDA context). The engine runs on ``wcfg["device"]``,
    which the root always sets."""
    ocfg = wcfg.get("obs") or {}
    if ocfg.get("trace"):
        obs_trace.arm(
            obs_fanin.suffixed_path(ocfg.get("trace_path", ""), wid)
            or None,
            tags={"role": "serve-worker", "worker": wid})
    obs_flight.configure(
        capacity=ocfg.get("flight_capacity"),
        path=obs_fanin.suffixed_path(ocfg.get("flight_path", ""), wid))
    # arm the serving health rules in-process: the engine's dispatch
    # boundary evaluates them, /healthz degrades, nidt_alert fires
    obs_rules.configure(obs_rules.builtin_rules())
    bundle = load_bundle(wcfg["bundle"])
    engine = ServeEngine(bundle,
                         batch_buckets=tuple(wcfg["batch_buckets"]),
                         max_queue_ms=wcfg["max_queue_ms"],
                         precision=wcfg.get("precision", ""),
                         device=wcfg["device"])
    worker = _ServeWorkerProc(wid, engine, conn, wcfg["port"],
                              max_body=wcfg.get("max_body",
                                                MAX_BODY_BYTES))
    try:
        worker.run()
    except Exception:  # noqa: BLE001 — log the real error before the
        # process dies; the root sees the pipe sentinel either way
        log.exception("serve worker %d crashed", wid)
        raise
