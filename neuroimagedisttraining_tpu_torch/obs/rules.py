"""Declarative anomaly-rule engine: metric streams -> verdicts (the
reference package's ``obs/rules.py``; the same rules, manifests and
verdicts).

Rules are data: a metric selector (name and label match), a window
aggregation over the last N observations, a comparator, a threshold, a
severity and a ``for_rounds`` debounce, evaluated at the engine's host
boundaries against registry snapshots. One evaluation gives:

- ``nidt_alert{rule, severity}``: 1 while the rule fires, 0 otherwise
  (the series exists from the first evaluation either way);
- a flight-ring ``alert`` event on every rising edge (``alert_clear`` on
  the fall);
- a ``health`` block for ``/healthz``: ``ok``, ``degraded`` (a warn rule
  firing) or ``critical``;
- the end-of-run ``verdict()`` written to ``.health.json``, which
  ``--health_gate`` exits nonzero on;
- a reflex dispatch on every rising edge of a rule that declares an
  ``action`` (``obs/actions.py``, gated by ``--actions``).

Validation is a startup contract: a rule's metric must be in the
declared-name set (``obs/names.py``), built in or loaded from a
``--health_rules`` JSON manifest, or it raises with the known names.

- A comparison with NaN is False, so a poisoned gauge never fires a rule
  (the non-finite upload guard carries that failure).
- A rule whose metric has no samples does not evaluate at that boundary,
  and its debounce restarts.
- A histogram cell evaluates as its p99 (interpolated in the cumulative
  buckets).
- Several label cells matching one selector reduce with the rule's
  ``agg`` (max by default: any series over the threshold).

Host boundaries only: evaluation reads clocks and mutates the registry.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
from collections import deque
from typing import Any, Iterable, Mapping

from neuroimagedisttraining_tpu_torch.obs import actions as obs_actions
from neuroimagedisttraining_tpu_torch.obs import flight as obs_flight
from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
from neuroimagedisttraining_tpu_torch.obs import names as N

__all__ = [
    "HealthRule", "RuleEngine", "builtin_rules", "load_rules",
    "configure", "disarm", "active", "observe_boundary", "health_block",
    "OPS", "WINDOWS", "SEVERITIES",
]

#: comparators a rule may name (NaN fails them all — see module doc)
OPS = (">", ">=", "<", "<=", "==", "!=")
#: window aggregations over the last ``n`` observations
WINDOWS = ("last", "mean", "max", "min", "delta")
SEVERITIES = ("warn", "critical")
#: label-cell reductions when one selector matches several series
AGGS = ("max", "min", "sum")

#: timeline ring bound (evictions are counted, never silent)
TIMELINE_CAP = 512


@dataclasses.dataclass(frozen=True)
class HealthRule:
    """One rule-as-data row. ``labels`` is a subset match: a cell fires
    the selector when every named label equals the cell's value (extra
    cell labels — ``worker`` on fan-in-merged snapshots — are
    ignored, which is exactly how a root rule fires on a worker's
    series)."""

    name: str
    metric: str
    op: str
    threshold: float
    labels: tuple[tuple[str, str], ...] = ()
    window: str = "last"
    n: int = 1
    severity: str = "warn"
    for_rounds: int = 1
    agg: str = "max"
    description: str = ""
    #: optional flight-ring event kind recorded on every RISING edge in
    #: addition to the standard ``alert`` event — how a rule names the
    #: operator action it recommends (the autotuner's mfu-below-recipe
    #: rule records ``retune_recommended``; tune/recipe.py)
    on_fire_event: str = ""
    #: optional reflex action (obs/actions.py BUILTIN_ACTIONS)
    #: dispatched through the armed action bus on every rising edge;
    #: gated by ``--actions {off,dry_run,on}``, validated at startup
    action: str = ""

    def validate(self, known: frozenset[str]) -> None:
        if self.metric not in known:
            raise ValueError(
                f"health rule {self.name!r} references unknown metric "
                f"{self.metric!r}; declared metric names "
                f"(obs/names.py): {sorted(known)}")
        if self.op not in OPS:
            raise ValueError(
                f"health rule {self.name!r}: unknown comparator "
                f"{self.op!r} (have {OPS})")
        if self.window not in WINDOWS:
            raise ValueError(
                f"health rule {self.name!r}: unknown window "
                f"{self.window!r} (have {WINDOWS})")
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"health rule {self.name!r}: unknown severity "
                f"{self.severity!r} (have {SEVERITIES})")
        if self.agg not in AGGS:
            raise ValueError(
                f"health rule {self.name!r}: unknown cell aggregation "
                f"{self.agg!r} (have {AGGS})")
        if self.n < 1 or self.for_rounds < 1:
            raise ValueError(
                f"health rule {self.name!r}: window n and for_rounds "
                f"must be >= 1 (got n={self.n}, "
                f"for_rounds={self.for_rounds})")
        if self.window == "delta" and self.n < 2:
            raise ValueError(
                f"health rule {self.name!r}: window 'delta' needs "
                f"n >= 2 (last - first of the window)")
        if not math.isfinite(float(self.threshold)):
            raise ValueError(
                f"health rule {self.name!r}: threshold must be finite")
        if self.action and self.action not in obs_actions.BUILTIN_ACTIONS:
            raise ValueError(
                f"health rule {self.name!r}: unknown action "
                f"{self.action!r}; registered actions "
                f"(obs/actions.py BUILTIN_ACTIONS): "
                f"{sorted(obs_actions.BUILTIN_ACTIONS)}")


def _hist_p99(cell: Mapping[str, Any]) -> float | None:
    """p99 from a snapshot histogram cell (per-bucket counts keyed by
    formatted upper bound + '+Inf'), linearly interpolated inside the
    crossing bucket; the +Inf bucket evaluates as its lower edge."""
    count = int(cell.get("count", 0))
    if count <= 0:
        return None
    buckets = dict(cell.get("buckets", {}))
    inf = int(buckets.pop("+Inf", 0))
    edges = sorted((float(k), int(v)) for k, v in buckets.items())
    target = 0.99 * count
    acc = 0
    lo = 0.0
    for edge, n_in in edges:
        if acc + n_in >= target and n_in > 0:
            frac = (target - acc) / n_in
            return lo + frac * (edge - lo)
        acc += n_in
        lo = edge
    # crossing lands in +Inf: report the last finite edge (the honest
    # "at least this much" answer a bounded histogram can give)
    return lo if (edges or inf) else None


def _cell_value(kind: str, value: Any) -> float | None:
    if kind == "histogram":
        if isinstance(value, Mapping):
            return _hist_p99(value)
        return None
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


def _compare(op: str, v: float, thr: float) -> bool:
    # NaN: every comparison below is False, including == (and != is
    # deliberately evaluated the same guarded way)
    if math.isnan(v):
        return False
    if op == ">":
        return v > thr
    if op == ">=":
        return v >= thr
    if op == "<":
        return v < thr
    if op == "<=":
        return v <= thr
    if op == "==":
        return v == thr
    return v != thr


class _RuleState:
    __slots__ = ("window", "consec", "firing", "fires", "last_value",
                 "last_round")

    def __init__(self, n: int):
        self.window: deque = deque(maxlen=n)
        self.consec = 0
        self.firing = False
        self.fires = 0
        self.last_value: float | None = None
        self.last_round: int | None = None


class RuleEngine:
    """Holds the rule set + per-rule evaluation state. Thread-safe:
    dispatch threads evaluate boundaries while HTTP scrape threads read
    ``health_block()``."""

    def __init__(self, rules: Iterable[HealthRule],
                 known: frozenset[str] = N.DECLARED):
        rules = list(rules)
        seen: set[str] = set()
        for r in rules:
            r.validate(known)
            if r.name in seen:
                raise ValueError(
                    f"health rule {r.name!r} declared twice — rule "
                    "names are the alert label and must be unique")
            seen.add(r.name)
        self.rules = tuple(rules)
        self._by_name = {r.name: r for r in self.rules}
        self._lock = threading.Lock()
        self._state = {r.name: _RuleState(r.n) for r in rules}
        self._rounds_evaluated = 0
        self._last_round: int | None = None
        self._worst = "ok"
        self._timeline: deque = deque(maxlen=TIMELINE_CAP)
        self._timeline_evicted = 0
        self._alert_gauge = obs_metrics.gauge(
            N.ALERT,
            "anomaly-rule verdicts (obs/rules.py): 1 while the rule's "
            "debounced condition holds, 0 otherwise",
            labelnames=("rule", "severity"))

    # ---- evaluation (host boundaries) ----

    def observe(self, round_idx: int, snapshot: dict | None = None
                ) -> list[dict]:
        """Evaluate every rule against ``snapshot`` (default: the
        process registry) at boundary ``round_idx``. Re-observing an
        already-evaluated round is a no-op (the engine flush path and
        ``publish_stat_info`` may both land on the same boundary).
        Returns the edge events of this evaluation."""
        snap = (snapshot if snapshot is not None
                else obs_metrics.REGISTRY.snapshot())
        edges: list[dict] = []
        with self._lock:
            if self._last_round is not None \
                    and round_idx <= self._last_round:
                return []
            self._last_round = int(round_idx)
            self._rounds_evaluated += 1
            for rule in self.rules:
                st = self._state[rule.name]
                v = self._select(rule, snap)
                if v is None:
                    # no samples yet: not an anomaly, and the debounce
                    # restarts when evidence reappears
                    st.consec = 0
                    self._settle(rule, st, round_idx, edges,
                                 firing=False)
                    continue
                st.window.append(v)
                st.last_value = v
                st.last_round = int(round_idx)
                wv = self._window_value(rule, st)
                breach = _compare(rule.op, wv, float(rule.threshold))
                st.consec = st.consec + 1 if breach else 0
                self._settle(rule, st, round_idx, edges,
                             firing=st.consec >= rule.for_rounds,
                             value=wv)
        for e in edges:
            obs_flight.record(e["kind"], rule=e["rule"],
                              severity=e["severity"], round=e["round"],
                              value=e.get("value"))
            r = self._by_name.get(e["rule"])
            if e["kind"] == "alert" and r is not None and r.on_fire_event:
                obs_flight.record(r.on_fire_event, rule=e["rule"],
                                  round=e["round"],
                                  value=e.get("value"))
            if e["kind"] == "alert" and r is not None and r.action:
                # reflex dispatch through the armed action bus (a no-op
                # when none is armed; dry_run only logs), outside the
                # lock: handlers may re-enter the registry
                obs_actions.on_alert(r.action, rule=r.name,
                                     severity=r.severity,
                                     round_idx=e["round"],
                                     value=e.get("value"))
        return edges

    def _select(self, rule: HealthRule, snap: dict) -> float | None:
        m = snap.get(rule.metric)
        if not m:
            return None
        want = dict(rule.labels)
        vals: list[float] = []
        for cell in m.get("values", ()):
            lb = cell.get("labels", {})
            if any(lb.get(k) != v for k, v in want.items()):
                continue
            cv = _cell_value(m.get("kind", "gauge"), cell.get("value"))
            if cv is not None:
                vals.append(cv)
        if not vals:
            return None
        if rule.agg == "min":
            return min(vals)
        if rule.agg == "sum":
            return float(sum(vals))
        return max(vals)

    @staticmethod
    def _window_value(rule: HealthRule, st: _RuleState) -> float:
        w = list(st.window)
        if rule.window == "mean":
            return float(sum(w) / len(w))
        if rule.window == "max":
            return max(w)
        if rule.window == "min":
            return min(w)
        if rule.window == "delta":
            return w[-1] - w[0]
        return w[-1]

    def _settle(self, rule: HealthRule, st: _RuleState, round_idx: int,
                edges: list[dict], firing: bool,
                value: float | None = None) -> None:
        self._alert_gauge.labels(rule=rule.name,
                                 severity=rule.severity).set(
            1.0 if firing else 0.0)
        if firing and not st.firing:
            st.fires += 1
            if rule.severity == "critical":
                self._worst = "critical"
            elif self._worst == "ok":
                self._worst = "degraded"
            edges.append({"kind": "alert", "rule": rule.name,
                          "severity": rule.severity,
                          "round": int(round_idx), "value": value})
        elif st.firing and not firing:
            edges.append({"kind": "alert_clear", "rule": rule.name,
                          "severity": rule.severity,
                          "round": int(round_idx), "value": value})
        st.firing = firing
        if edges and edges[-1]["round"] == int(round_idx) \
                and edges[-1]["rule"] == rule.name:
            if len(self._timeline) == self._timeline.maxlen:
                self._timeline_evicted += 1
            self._timeline.append(dict(edges[-1]))

    # ---- reports ----

    def status(self) -> str:
        with self._lock:
            return self._status_locked()

    def _status_locked(self) -> str:
        worst_now = "ok"
        for rule in self.rules:
            if self._state[rule.name].firing:
                if rule.severity == "critical":
                    return "critical"
                worst_now = "degraded"
        return worst_now

    def health_block(self) -> dict:
        """The ``/healthz`` ``health`` block."""
        with self._lock:
            firing = {r.name: r.severity for r in self.rules
                      if self._state[r.name].firing}
            return {"status": self._status_locked(),
                    "worst_status": self._worst,
                    "firing": firing,
                    "rules": len(self.rules),
                    "rounds_evaluated": self._rounds_evaluated}

    def verdict(self) -> dict:
        """The machine-readable end-of-run document ``--health_gate``
        judges (``worst_status`` — a recovered run still failed its
        gate) and ``analysis/run_report.py`` joins (the timeline)."""
        with self._lock:
            rules = []
            for r in self.rules:
                st = self._state[r.name]
                rules.append({
                    "name": r.name, "metric": r.metric,
                    "severity": r.severity, "op": r.op,
                    "threshold": r.threshold, "window": r.window,
                    "n": r.n, "for_rounds": r.for_rounds,
                    "firing": st.firing, "fires": st.fires,
                    "last_value": st.last_value,
                    "last_round": st.last_round,
                    "description": r.description,
                    "action": r.action,
                })
            return obs_metrics._json_safe({
                "status": self._status_locked(),
                "worst_status": self._worst,
                "rounds_evaluated": self._rounds_evaluated,
                "alerts_total": sum(r["fires"] for r in rules),
                "rules": rules,
                "timeline": list(self._timeline),
                "timeline_evicted": self._timeline_evicted,
            })


# ---------------------------------------------------------------------------
# built-in manifest
# ---------------------------------------------------------------------------


def builtin_rules(dp_epsilon_budget: float = 0.0, comm_round: int = 200,
                  max_staleness: int = 20) -> list[HealthRule]:
    """The shipped rule manifest — one rule per failure mode the
    motivation names. Thresholds are deliberately conservative (verdict
    tripwires, not noise detectors); ``--health_rules`` JSON manifests
    extend or replace them."""
    rules = [
        HealthRule(
            name="client-divergence", metric=N.HEALTH_COSINE_MIN,
            op="<", threshold=-0.2, severity="critical",
            action="quarantine_silo",
            description=(
                "a client update points AGAINST the aggregated update "
                "(sign-flip Byzantine, or non-IID divergence past what "
                "FedProx-style proximal terms absorb)")),
        HealthRule(
            name="defense-escalation", metric=N.HEALTH_COSINE_MIN,
            op="<", threshold=-0.5, severity="warn",
            action="escalate_defense",
            description=(
                "a strongly anti-aligned client update (cosine < -0.5) "
                "is an attack signature, not non-IID drift — escalate "
                "the robust-aggregation ladder one rung (none -> "
                "norm_diff_clipping -> trimmed_mean)")),
        HealthRule(
            name="update-norm-collapse",
            metric=N.HEALTH_UPDATE_NORM_MED, op="<", threshold=1e-7,
            for_rounds=2, severity="warn",
            description=(
                "median client update norm ~ 0: local training is a "
                "no-op (lr underflow, dead data feed, all-masked "
                "params)")),
        HealthRule(
            name="update-norm-blowup", metric=N.HEALTH_DIVERGENCE,
            op=">", threshold=50.0, for_rounds=2, severity="warn",
            action="freeze_rollback",
            description=(
                "max/median client update-norm dispersion: one silo's "
                "update dwarfs the cohort (diverging optimizer or "
                "scale attack below the non-finite guard)")),
        HealthRule(
            name="dead-mask", metric=N.HEALTH_MASK_DENSITY, op="<",
            threshold=0.01, severity="critical",
            description=(
                "a salientgrads/dispfl/subavg mask lost (nearly) every "
                "weight — the NaN-poisoned fire/regrow footprint")),
        HealthRule(
            name="recompile-storm", metric=N.RECOMPILES_TOTAL, op=">=",
            threshold=3, severity="warn",
            description=(
                "the same compiled program rebuilt mid-run 3+ times "
                "(plan-cache thrash / shape leak) — every hot-path "
                "dispatch is paying a fresh compile or graph capture")),
        HealthRule(
            name="mfu-floor", metric=N.MFU, op="<", threshold=0.02,
            for_rounds=3, severity="warn",
            description=(
                "sustained MFU under 2% for 3 boundaries: the device "
                "is idling (host-bound feed, serialized dispatch); "
                "no samples without a known peak, so the rule judges "
                "accelerator runs only")),
        HealthRule(
            name="staleness-runaway", metric=N.ASYNC_STALENESS, op=">",
            threshold=max(1.0, 0.8 * float(max_staleness)),
            for_rounds=2, severity="warn", action="adapt_buffer",
            description=(
                "p99 accepted-upload staleness near the admission "
                "bound: the buffered server is aggregating history")),
        HealthRule(
            name="region-staleness-runaway", metric=N.REGION_STALENESS,
            op=">", threshold=max(1.0, 0.8 * float(max_staleness)),
            for_rounds=2, severity="warn", action="adapt_buffer",
            description=(
                "a regional sub-aggregator's batch staleness near the "
                "admission bound for 2 boundaries: that region is "
                "shipping history — its workers are wedged, its uplink "
                "is backed up, or its client population stalled "
                "(any-region-over semantics via the max cell "
                "aggregation)")),
        HealthRule(
            name="quarantine-burst", metric=N.BYZ_QUARANTINES,
            op=">=", threshold=2, window="delta", n=5, severity="warn",
            action="escalate_defense",
            description=(
                "2+ quarantines entered within 5 boundaries — a "
                "coordinated anomaly, not one flaky silo")),
        # -- serving plane: evaluated at the engine's dispatch
        #    boundary inside each serve worker --
        HealthRule(
            name="serve-p99-latency", metric=N.SERVE_LATENCY_MS,
            op=">", threshold=1000.0,
            labels=(("stage", "dispatch"),), for_rounds=2,
            severity="warn",
            description=(
                "p99 dispatch-stage serving latency above 1s for 2 "
                "boundaries: the compiled forward no longer keeps up "
                "with the offered load (bucket misconfiguration, "
                "recompile storm, or host contention)")),
        HealthRule(
            name="serve-queue-runaway", metric=N.SERVE_QUEUE_DEPTH,
            op=">", threshold=512.0, for_rounds=2, severity="warn",
            description=(
                "512+ requests queued behind the micro-batcher for 2 "
                "boundaries: arrival rate exceeds dispatch throughput "
                "and waiters are compounding (/predict is about to "
                "time out)")),
    ]
    if dp_epsilon_budget > 0:
        rules.append(HealthRule(
            name="dp-budget-exceeded", metric=N.DP_EPSILON, op=">=",
            threshold=float(dp_epsilon_budget), severity="critical",
            description=(
                "the RDP ledger crossed --dp_epsilon_budget: every "
                "further round spends privacy the run was not "
                "budgeted for")))
        rules.append(HealthRule(
            name="dp-burn-rate", metric=N.DP_EPSILON_PER_ROUND, op=">",
            threshold=2.0 * float(dp_epsilon_budget)
            / max(1, int(comm_round)),
            for_rounds=3, severity="warn",
            description=(
                "per-round epsilon burn exceeds 2x the uniform "
                "budget/comm_round rate for 3 boundaries — the run "
                "will cross the budget early")))
    return rules


def load_rules(path: str) -> list[HealthRule]:
    """``--health_rules`` JSON manifest: a list of rule objects with
    the :class:`HealthRule` field names (``labels`` as an object).
    Schema errors and unknown metric names raise at startup."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, list):
        raise ValueError(
            f"health-rule manifest {path}: expected a JSON list of "
            f"rule objects, got {type(doc).__name__}")
    fields = {f.name for f in dataclasses.fields(HealthRule)}
    out = []
    for i, row in enumerate(doc):
        if not isinstance(row, dict):
            raise ValueError(
                f"health-rule manifest {path}[{i}]: expected an "
                f"object, got {type(row).__name__}")
        unknown = set(row) - fields
        if unknown:
            raise ValueError(
                f"health-rule manifest {path}[{i}]: unknown fields "
                f"{sorted(unknown)} (have {sorted(fields)})")
        missing = {"name", "metric", "op", "threshold"} - set(row)
        if missing:
            raise ValueError(
                f"health-rule manifest {path}[{i}]: missing required "
                f"fields {sorted(missing)}")
        labels = row.get("labels", {})
        if not isinstance(labels, dict):
            raise ValueError(
                f"health-rule manifest {path}[{i}]: labels must be an "
                "object")
        row = dict(row, labels=tuple(sorted(
            (str(k), str(v)) for k, v in labels.items())))
        out.append(HealthRule(**row))
    return out


# ---------------------------------------------------------------------------
# the process-global engine (armed by the CLIs; tests build their own)
# ---------------------------------------------------------------------------

_ACTIVE: RuleEngine | None = None
_ACTIVE_LOCK = threading.Lock()


def configure(rules: Iterable[HealthRule] | None = None, *,
              manifest_path: str = "", dp_epsilon_budget: float = 0.0,
              comm_round: int = 200, max_staleness: int = 20,
              extra_rules: Iterable[HealthRule] | None = None
              ) -> RuleEngine:
    """Arm the process-global rule engine: the built-in manifest
    (parameterized by the run's budget/schedule), plus — or replaced
    by — an explicit rule list / ``--health_rules`` JSON manifest
    (manifest rules EXTEND the built-ins; same-named rules override).
    ``extra_rules`` are programmatic additions merged AFTER the
    built-ins and BEFORE the manifest (a recipe's drift rule — the
    operator's JSON still wins)."""
    global _ACTIVE
    base = {r.name: r for r in (rules if rules is not None
                                else builtin_rules(
                                    dp_epsilon_budget=dp_epsilon_budget,
                                    comm_round=comm_round,
                                    max_staleness=max_staleness))}
    for r in (extra_rules or ()):
        base[r.name] = r
    if manifest_path:
        for r in load_rules(manifest_path):
            base[r.name] = r
    eng = RuleEngine(base.values())
    with _ACTIVE_LOCK:
        _ACTIVE = eng
    return eng


def disarm() -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = None


def active() -> RuleEngine | None:
    with _ACTIVE_LOCK:
        return _ACTIVE


def observe_boundary(round_idx: int, snapshot: dict | None = None
                     ) -> list[dict]:
    """Evaluate the armed engine at a host boundary; a no-op (empty
    edge list) when no engine is armed — instrumentation sites call
    this unconditionally."""
    eng = active()
    return eng.observe(round_idx, snapshot) if eng is not None else []


def health_block() -> dict:
    """The ``/healthz`` ``health`` block — ``{"status": "unarmed"}``
    when no rule engine is configured."""
    eng = active()
    return (eng.health_block() if eng is not None
            else {"status": "unarmed"})
