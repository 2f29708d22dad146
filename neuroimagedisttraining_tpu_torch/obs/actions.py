"""Reflex plane: the action registry that rule verdicts resolve against
(the reference package's ``obs/actions.py``).

The anomaly-rule engine (``obs/rules.py``) turns metric streams into
verdicts; this module turns verdicts into acts. A rule may declare an
``action``, a name from :data:`BUILTIN_ACTIONS`, and every rising alert
edge of that rule dispatches through the process-global
:class:`ActionBus`:

- ``--actions off``: nothing is dispatched or logged;
- ``--actions dry_run`` (the default): the bus records what would fire
  (an ``action_dry_run`` flight event and an action-log entry), but no
  handler runs, so behaviour never changes silently;
- ``--actions on``: the registered handler runs. An action without a
  handler on this plane (``adapt_buffer`` in-process) is logged
  ``unhandled``; a handler that raises is logged ``error``: a reflex never
  stops the training it protects.

The engines register ``quarantine_silo``, ``escalate_defense`` and
``freeze_rollback`` when ``train()`` starts (``engines/base.py``
``register_reflexes``); registration is latest-wins. Every dispatch is
flight-recorded with the firing rule as its provenance and counted in
``nidt_actions_total{action, status}``. The action log carries no time
stamps, so two runs of the same seeded fault schedule give equal logs;
the flight ring carries the clocks.

Host boundaries only: a dispatch mutates the registry and the flight
ring, and runs between rounds, never inside a local step.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable

from neuroimagedisttraining_tpu_torch.obs import flight as obs_flight
from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
from neuroimagedisttraining_tpu_torch.obs import names as N

__all__ = [
    "BUILTIN_ACTIONS", "MODES", "ActionBus", "configure", "disarm",
    "active", "register", "on_alert", "record_action", "actions_block",
]

#: every action a rule may declare -> what firing it does (the
#: reference's table, validated against at startup)
BUILTIN_ACTIONS: dict = {
    "quarantine_silo": (
        "quarantine the client/silo whose update diverges most from "
        "the cohort (min leave-one-out cosine): dropped from sampling "
        "and aggregation for a fixed window of rounds"),
    "escalate_defense": (
        "step the robust-aggregation ladder one rung: none -> "
        "norm_diff_clipping -> trimmed_mean (round programs re-plan "
        "with the escalated defense)"),
    "adapt_buffer": (
        "adapt the async server's concurrency to the measured arrival "
        "process: halve buffer_k (floor 1) and raise staleness_alpha "
        "(the FedBuff runtime-knob reading of staleness runaway)"),
    "freeze_rollback": (
        "freeze the current (blown-up) state and roll back to the "
        "last healthy pinned state at the next host boundary, "
        "zeroing the codec error-feedback accumulators"),
    "shrink_mesh": (
        "re-plan the client mesh over the surviving devices after a "
        "device loss / preemption and resume from the last "
        "donation-safe checkpoint (elastic compute plane)"),
}

#: ``--actions`` gate values (off = no dispatch at all; dry_run logs
#: what WOULD fire; on runs registered handlers)
MODES = ("off", "dry_run", "on")

#: bounded action-log ring (evictions counted, never silent)
LOG_CAP = 256

#: dispatch outcomes the counter/log can carry
STATUSES = ("applied", "dry_run", "unhandled", "skipped", "error")


class ActionBus:
    """Holds the mode, the registered handlers, and the bounded
    deterministic action log. Thread-safe: server ingest threads
    dispatch while HTTP scrape threads read ``actions_block()``."""

    def __init__(self, mode: str = "dry_run", log_cap: int = LOG_CAP):
        if mode not in MODES:
            raise ValueError(
                f"--actions must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self._lock = threading.Lock()
        self._handlers: dict[str, Callable[..., dict | None]] = {}
        self._log: deque = deque(maxlen=int(log_cap))
        self._evicted = 0
        self._total = 0
        self._counter = obs_metrics.counter(
            N.ACTIONS_TOTAL,
            "reflex-plane action dispatches (obs/actions.py), by "
            "action name and outcome status",
            labelnames=("action", "status"))

    # ---- registration (the planes that can realize an action) ----

    def register(self, action: str,
                 fn: Callable[..., dict | None]) -> None:
        """Register ``fn(rule=..., round_idx=..., value=...) ->
        detail-dict|None`` as the realization of ``action`` on this
        plane. Latest wins (a restarted driver re-arms cleanly);
        unknown action names fail loudly — registration happens at
        plane startup, where failing is cheap."""
        if action not in BUILTIN_ACTIONS:
            raise ValueError(
                f"cannot register handler for unknown action "
                f"{action!r}; registered actions (obs/actions.py "
                f"BUILTIN_ACTIONS): {sorted(BUILTIN_ACTIONS)}")
        with self._lock:
            self._handlers[action] = fn

    # ---- dispatch ----

    def _append(self, entry: dict) -> None:
        with self._lock:
            self._total += 1
            if len(self._log) == self._log.maxlen:
                self._evicted += 1
            self._log.append(entry)

    def on_alert(self, action: str, *, rule: str, severity: str = "",
                 round_idx: int | None = None,
                 value: float | None = None) -> dict | None:
        """Dispatch one rising alert edge's declared action. Returns
        the action-log entry (None in ``off`` mode). NEVER raises: a
        handler exception becomes an ``error`` entry — reflexes must
        not kill the training they protect."""
        if self.mode == "off":
            return None
        entry: dict[str, Any] = {
            "action": action, "rule": rule, "severity": severity,
            "round": None if round_idx is None else int(round_idx),
            "value": None if value is None else float(value),
            "dry_run": self.mode != "on",
        }
        if action not in BUILTIN_ACTIONS:
            # rule validation makes this unreachable for engine-built
            # rules; guard anyway so a hand-built RuleEngine cannot
            # crash a boundary through the bus
            entry.update(status="error",
                         detail={"error": f"unknown action {action!r}"})
        elif self.mode == "dry_run":
            entry["status"] = "dry_run"
        else:
            with self._lock:
                fn = self._handlers.get(action)
            if fn is None:
                # this plane has no realization of the action (e.g.
                # adapt_buffer on an in-process engine run)
                entry["status"] = "unhandled"
            else:
                try:
                    detail = fn(rule=rule, round_idx=round_idx,
                                value=value)
                    detail = dict(detail or {})
                    entry["status"] = detail.pop("status", "applied")
                    if detail:
                        entry["detail"] = detail
                except Exception as e:  # noqa: BLE001 — reflex
                    # containment: an acting handler must never
                    # propagate into the host boundary that fired it
                    entry["status"] = "error"
                    entry["detail"] = {"error": str(e)}
        self._counter.labels(action=action,
                             status=entry["status"]).inc()
        obs_flight.record(
            "action_dry_run" if entry["dry_run"] else "action",
            action=action, rule=rule, status=entry["status"],
            round=entry["round"], value=entry["value"])
        self._append(entry)
        return entry

    def record_action(self, action: str, *, rule: str,
                      round_idx: int | None = None,
                      status: str = "applied",
                      detail: dict | None = None) -> dict:
        """Record a plane-initiated action (no firing rule edge): the
        elastic-mesh shrink is driven by the device-loss event itself,
        not a metric rule, so it records here with its provenance
        string (``rule="device-loss"``) and is NOT mode-gated — an
        explicit injected fault always leaves its trace."""
        entry: dict[str, Any] = {
            "action": action, "rule": rule, "severity": "",
            "round": None if round_idx is None else int(round_idx),
            "value": None, "dry_run": False, "status": status,
        }
        if detail:
            entry["detail"] = dict(detail)
        self._counter.labels(action=action, status=status).inc()
        obs_flight.record("action", action=action, rule=rule,
                          status=status, round=entry["round"],
                          value=None)
        self._append(entry)
        return entry

    # ---- reports ----

    def actions_block(self, last: int = 50) -> dict:
        """The ``/healthz`` / verdict ``actions`` block: mode, which
        actions have registered handlers on this plane, totals, and
        the last ``last`` log entries (rule provenance + dry_run flag
        on each — the operator audit the satellite asks for)."""
        with self._lock:
            log = list(self._log)[-int(last):]
            return {"mode": self.mode,
                    "registered": sorted(self._handlers),
                    "total": self._total,
                    "evicted": self._evicted,
                    "log": log}


# ---------------------------------------------------------------------------
# the process-global bus (armed by the CLIs; tests build their own)
# ---------------------------------------------------------------------------

_ACTIVE: ActionBus | None = None
_ACTIVE_LOCK = threading.Lock()


def configure(mode: str = "dry_run", log_cap: int = LOG_CAP
              ) -> ActionBus:
    """Arm the process-global action bus at ``--actions`` mode. Returns
    the bus — CLIs keep the handle so end-of-run reports can read the
    log after :func:`disarm`."""
    global _ACTIVE
    bus = ActionBus(mode, log_cap=log_cap)
    with _ACTIVE_LOCK:
        _ACTIVE = bus
    return bus


def disarm() -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = None


def active() -> ActionBus | None:
    with _ACTIVE_LOCK:
        return _ACTIVE


def register(action: str, fn: Callable[..., dict | None]) -> None:
    """Register a handler on the armed bus; a no-op when no bus is
    armed (tests and library callers run engines without the CLI)."""
    bus = active()
    if bus is not None:
        bus.register(action, fn)


def on_alert(action: str, *, rule: str, severity: str = "",
             round_idx: int | None = None,
             value: float | None = None) -> dict | None:
    """Dispatch through the armed bus; None when unarmed —
    instrumentation sites (obs/rules.py) call this unconditionally."""
    bus = active()
    if bus is None:
        return None
    return bus.on_alert(action, rule=rule, severity=severity,
                        round_idx=round_idx, value=value)


def record_action(action: str, *, rule: str,
                  round_idx: int | None = None,
                  status: str = "applied",
                  detail: dict | None = None) -> dict | None:
    """Record a plane-initiated action on the armed bus (None when
    unarmed)."""
    bus = active()
    if bus is None:
        return None
    return bus.record_action(action, rule=rule, round_idx=round_idx,
                             status=status, detail=detail)


def actions_block(last: int = 50) -> dict:
    """The ``actions`` block for probes/verdicts —
    ``{"mode": "unarmed"}`` when no bus is configured."""
    bus = active()
    return (bus.actions_block(last) if bus is not None
            else {"mode": "unarmed"})
