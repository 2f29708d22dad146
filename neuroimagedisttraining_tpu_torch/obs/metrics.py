"""Metrics registry: labeled Counters, Gauges and Histograms in one home
(the reference package's ``obs/metrics.py``).

``stat_info`` (``engines/base.py``), the experiment log's round metrics
(``utils/logging.py``), the health stats, the compute profiler's gauges
and the rule and action counters all publish here, so one scrape
(``/metrics``, ``obs/http.py``), one ``snapshot()`` or one JSONL line
carries the run's state. The registry's values equal the legacy
surfaces' values, with no double counting.

- Stdlib only and thread-safe: one registry lock; a mutation is a dict
  lookup and a float add under it.
- Idempotent registration: ``counter(name, ...)`` returns the metric
  already registered under ``name``; another kind, labels or buckets
  under the same name raises.
- Labels: ``c.labels(rank="0").inc()`` or ``c.inc(5, rank="0")``.
- Exposition: the Prometheus text format 0.0.4 (``prometheus_text()``),
  a structured ``snapshot()`` and an append-only JSONL sink
  (``dump_jsonl``), with non-finite values spelled ``NaN`` / ``+Inf`` /
  ``-Inf`` (JSON has no token for them).
- ``disable()`` / ``enable()``: a process-wide switch for measuring the
  registry's own cost; a disabled mutation is one attribute test.

Host boundaries only: a metric is never mutated inside a local step.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Iterable, Mapping

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "snapshot", "prometheus_text",
    "reset", "enable", "disable",
]

#: default histogram buckets (seconds-flavored, Prometheus defaults)
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0)


def _escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _fmt(v: float) -> str:
    """Prometheus value formatting: integers without the trailing .0,
    canonical NaN/+Inf/-Inf spellings (repr's 'nan'/'inf' are not valid
    exposition tokens)."""
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _json_safe(obj):
    """Non-finite floats -> canonical strings: json.dumps would emit
    bare NaN/Infinity tokens that strict JSON parsers refuse, and a NaN
    train_loss IS reachable (the non-finite guards exist because losses
    diverge)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return _fmt(obj)
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_json_safe(v) for v in obj]
    return obj


class _Bound:
    """A metric bound to one label-value tuple."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "_Metric", key: tuple):
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._metric._inc(self._key, amount)

    def set(self, value: float) -> None:
        self._metric._set(self._key, value)

    def observe(self, value: float) -> None:
        self._metric._observe(self._key, value)

    def get(self):
        return self._metric._get(self._key)


class _Metric:
    """Shared label machinery; subclasses define the value cell."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: tuple[str, ...]):
        self._registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._cells: dict[tuple, Any] = {}

    # -- label plumbing --

    def _key_of(self, labels: Mapping[str, Any]) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(labels)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def labels(self, **labels: Any) -> _Bound:
        return _Bound(self, self._key_of(labels))

    # -- unlabeled shorthands (labels may also ride as kwargs) --

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        self._inc(self._key_of(labels), amount)

    def set(self, value: float, **labels: Any) -> None:
        self._set(self._key_of(labels), value)

    def observe(self, value: float, **labels: Any) -> None:
        self._observe(self._key_of(labels), value)

    def get(self, **labels: Any):
        return self._get(self._key_of(labels))

    # -- cell ops (subclass) --

    def _inc(self, key: tuple, amount: float) -> None:
        raise TypeError(f"{self.kind} {self.name!r} does not support inc()")

    def _set(self, key: tuple, value: float) -> None:
        raise TypeError(f"{self.kind} {self.name!r} does not support set()")

    def _observe(self, key: tuple, value: float) -> None:
        raise TypeError(
            f"{self.kind} {self.name!r} does not support observe()")

    def _get(self, key: tuple):
        # value materialized UNDER the lock: a histogram cell is mutable
        # (counts list + sum + count), and snapshotting it unlocked
        # could tear against a concurrent observe
        with self._registry._lock:
            return self._cell_value(self._cells.get(key))

    def _cell_value(self, cell):
        return 0.0 if cell is None else cell

    # -- exposition (under the registry lock) --

    def _label_str(self, key: tuple, extra: str = "") -> str:
        parts = [f'{n}="{_escape(v)}"'
                 for n, v in zip(self.labelnames, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def _expose(self) -> Iterable[str]:
        for key in sorted(self._cells):
            yield (f"{self.name}{self._label_str(key)} "
                   f"{_fmt(self._cells[key])}")

    def _snapshot_cell(self, cell):
        return cell


class Counter(_Metric):
    kind = "counter"

    def _inc(self, key: tuple, amount: float) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        reg = self._registry
        if not reg.enabled:
            return
        with reg._lock:
            self._cells[key] = self._cells.get(key, 0.0) + float(amount)


class Gauge(_Metric):
    kind = "gauge"

    def _set(self, key: tuple, value: float) -> None:
        reg = self._registry
        if not reg.enabled:
            return
        with reg._lock:
            self._cells[key] = float(value)

    def _inc(self, key: tuple, amount: float) -> None:
        reg = self._registry
        if not reg.enabled:
            return
        with reg._lock:
            self._cells[key] = self._cells.get(key, 0.0) + float(amount)


class _HistCell:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # last = overflow (+Inf)
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Fixed-bucket histogram. ``buckets`` are upper bounds (le); the
    implicit +Inf bucket always exists. Exposition renders CUMULATIVE
    bucket counts plus ``_sum``/``_count`` (Prometheus histogram
    semantics); ``snapshot()`` carries the per-bucket (non-cumulative)
    counts too."""

    kind = "histogram"

    def __init__(self, registry, name, help, labelnames,
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(registry, name, help, labelnames)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bs

    def _observe(self, key: tuple, value: float) -> None:
        reg = self._registry
        if not reg.enabled:
            return
        v = float(value)
        with reg._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = _HistCell(len(self.buckets))
            i = len(self.buckets)  # +Inf by default
            for j, b in enumerate(self.buckets):
                if v <= b:
                    i = j
                    break
            cell.counts[i] += 1
            cell.sum += v
            cell.count += 1

    def _cell_value(self, cell):
        if cell is None:
            return {"count": 0, "sum": 0.0,
                    "buckets": {_fmt(b): 0 for b in self.buckets}}
        return self._snapshot_cell(cell)

    def _expose(self) -> Iterable[str]:
        for key in sorted(self._cells):
            cell = self._cells[key]
            acc = 0
            for b, n in zip(self.buckets, cell.counts):
                acc += n
                le = self._label_str(key, f'le="{_fmt(b)}"')
                yield f"{self.name}_bucket{le} {acc}"
            le = self._label_str(key, 'le="+Inf"')
            yield f"{self.name}_bucket{le} {cell.count}"
            yield (f"{self.name}_sum{self._label_str(key)} "
                   f"{_fmt(cell.sum)}")
            yield (f"{self.name}_count{self._label_str(key)} "
                   f"{cell.count}")

    def _snapshot_cell(self, cell: _HistCell):
        out = {"count": cell.count, "sum": cell.sum, "buckets": {}}
        for b, n in zip(self.buckets, cell.counts):
            out["buckets"][_fmt(b)] = n
        out["buckets"]["+Inf"] = cell.counts[-1]
        return out


class MetricsRegistry:
    """One process's metric namespace. ``REGISTRY`` below is the global
    default every shipped instrumentation site publishes into; tests
    construct private registries or ``reset()`` the global one."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self.enabled = True

    # ---- registration (idempotent) ----

    def _register(self, kind: str, name: str, help: str,
                  labelnames: tuple[str, ...], **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}, not {kind}")
                if m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered with "
                        f"labels {m.labelnames}, not {tuple(labelnames)}")
                if kind == "histogram":
                    want = tuple(sorted(float(b)
                                        for b in kw["buckets"]))
                    if m.buckets != want:
                        # silently keeping the first registration's
                        # buckets would collapse the second caller's
                        # range into +Inf with no signal
                        raise ValueError(
                            f"histogram {name!r} already registered "
                            f"with buckets {m.buckets}, not {want}")
                return m
            m = self._KINDS[kind](self, name, help, tuple(labelnames),
                                  **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: tuple[str, ...] = ()) -> Counter:
        return self._register("counter", name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple[str, ...] = ()) -> Gauge:
        return self._register("gauge", name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._register("histogram", name, help, labelnames,
                              buckets=buckets)

    # ---- arm switch (overhead A/B) ----

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        """Disarm every mutation (one attribute test a call site)."""
        self.enabled = False

    def reset(self) -> None:
        """Drop every metric (tests; never called by shipped code)."""
        with self._lock:
            self._metrics.clear()

    # ---- output ----

    def snapshot(self) -> dict:
        """``{name: {"kind", "help", "values": [{"labels", "value"}]}}``
        — histograms' value is ``{count, sum, buckets}``."""
        with self._lock:
            out = {}
            for name, m in sorted(self._metrics.items()):
                vals = []
                for key in sorted(m._cells):
                    vals.append({
                        "labels": dict(zip(m.labelnames, key)),
                        "value": m._snapshot_cell(m._cells[key])})
                out[name] = {"kind": m.kind, "help": m.help,
                             "values": vals}
            return out

    def prometheus_text(self) -> str:
        """Text exposition format 0.0.4 (what ``/metrics`` serves)."""
        with self._lock:
            lines = []
            for name, m in sorted(self._metrics.items()):
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
                lines.extend(m._expose())
            return "\n".join(lines) + "\n"

    def dump_jsonl(self, path: str, **extra: Any) -> None:
        """Append one ``{"t": wall, "metrics": snapshot, **extra}`` line
        — the offline sink (scrapeless runs, post-hoc analysis)."""
        rec = _json_safe({"t": round(time.time(), 3), **extra,
                          "metrics": self.snapshot()})
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(rec, default=str) + "\n")


#: the process-global registry every shipped instrumentation site uses
REGISTRY = MetricsRegistry()

#: module-level conveniences (instrumentation-site spelling)
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
prometheus_text = REGISTRY.prometheus_text
reset = REGISTRY.reset
enable = REGISTRY.enable
disable = REGISTRY.disable
