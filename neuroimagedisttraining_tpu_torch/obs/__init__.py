"""``obs/``: the run's telemetry plane (the reference package's ``obs/``,
without its cross-process fan-in and profile-session driver).

- :mod:`obs.trace`: a thread-safe span tracer writing Chrome trace-event
  JSON (``--trace_out``); under ``--profile_dir`` each span also opens an
  NVTX range and a ``torch.profiler.record_function`` range.
- :mod:`obs.metrics`: the registry of labeled Counters, Gauges and
  Histograms, its Prometheus exposition and its JSONL sink
  (``--metrics_out``).
- :mod:`obs.flight`: the bounded ring of control-plane events, dumped by
  ``utils/profiling.failure_context``.
- :mod:`obs.http`: ``/metrics`` and ``/healthz`` (``--metrics_port``).
- :mod:`obs.compute`: dispatch times, graph captures, MFU against the
  card's peak, the FLOP counter's reconciliation.
- :mod:`obs.health`: the round's health stats as gauges
  (``--health_stats``).
- :mod:`obs.rules`: the anomaly rules and the run's verdict
  (``--health_rules``, ``--health_gate``).
- :mod:`obs.actions`: the reflex actions that firing rules dispatch
  (``--actions``).

Everything here runs on the host, at host boundaries (a round's or a
window's end, an evaluation), never inside a local step, and none of it
touches a device tensor. Disarmed, a span is a shared no-op.
"""

from neuroimagedisttraining_tpu_torch.obs import (  # noqa: F401
    actions, compute, flight, health, metrics, names, rules, trace,
)
from neuroimagedisttraining_tpu_torch.obs.flight import (  # noqa: F401
    FLIGHT, FlightRecorder,
)
from neuroimagedisttraining_tpu_torch.obs.metrics import (  # noqa: F401
    REGISTRY, MetricsRegistry,
)
from neuroimagedisttraining_tpu_torch.obs.trace import (  # noqa: F401
    TRACER, SpanTracer, span,
)

__all__ = [
    "FLIGHT", "FlightRecorder", "REGISTRY", "MetricsRegistry", "TRACER",
    "SpanTracer", "span", "actions", "compute", "flight", "health",
    "metrics", "names", "rules", "trace",
]
