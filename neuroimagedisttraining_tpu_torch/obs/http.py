"""``/metrics`` + ``/healthz``: a stdlib-only scrape endpoint.

``--metrics_port N`` on the CLI starts this (the reference package's
``obs/http.py``): a ``ThreadingHTTPServer`` on its own daemon thread
serving

- ``GET /metrics``  -> Prometheus text exposition of a registry
  (``text/plain; version=0.0.4``), scrape-compatible with any
  Prometheus/VictoriaMetrics/agent collector;
- ``GET /healthz``  -> one JSON object ``{"ok": true, "uptime_s": ...}``
  plus what the caller's probe reports (the CLI's: the compute block,
  the fallbacks, the rules' health and the reflex actions): the liveness
  endpoint a deployment points its probe at.

Scrapes run on the HTTP server's threads and only take the registry
lock for the duration of one text render: they never touch the
training thread or the card. Port 0 asks
the kernel for a free port (tests); the bound port is on ``.port``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from neuroimagedisttraining_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

__all__ = ["MetricsServer", "start_metrics_server"]

log = logging.getLogger("neuroimagedisttraining_tpu_torch.obs")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Owns the HTTP server + its thread; ``close()`` is idempotent."""

    def __init__(self, port: int, registry: MetricsRegistry | None = None,
                 health_probe: Callable[[], dict] | None = None,
                 host: str = "0.0.0.0"):
        registry = registry if registry is not None else REGISTRY
        t0 = time.monotonic()
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = registry.prometheus_text().encode()
                    self._reply(200, CONTENT_TYPE, body)
                elif path == "/healthz":
                    health = {"ok": True,
                              "uptime_s": round(time.monotonic() - t0, 3)}
                    if health_probe is not None:
                        try:
                            health.update(health_probe())
                        except Exception as e:  # noqa: BLE001 — a probe
                            # bug must degrade the health report, not
                            # kill the scrape thread
                            health["ok"] = False
                            health["probe_error"] = str(e)
                    self._reply(200 if health["ok"] else 503,
                                "application/json",
                                json.dumps(health).encode())
                else:
                    self._reply(404, "text/plain", b"not found\n")

            def _reply(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # scrapes are periodic —
                log.debug("metrics http: " + fmt, *args)  # keep stdout clean

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="nidt-metrics-http")
        self._thread.start()
        log.info("metrics endpoint on :%d (/metrics, /healthz)", self.port)

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)


def start_metrics_server(port: int,
                         registry: MetricsRegistry | None = None,
                         health_probe: Callable[[], dict] | None = None,
                         host: str = "0.0.0.0"
                         ) -> MetricsServer | None:
    """``--metrics_port`` entry point: 0 (the CLI default) means OFF and
    returns None; tests wanting an ephemeral port construct
    ``MetricsServer(0)`` directly. Callers hold the returned handle and
    ``close()`` it on shutdown."""
    if not port or int(port) <= 0:
        return None
    return MetricsServer(int(port), registry=registry,
                         health_probe=health_probe, host=host)
