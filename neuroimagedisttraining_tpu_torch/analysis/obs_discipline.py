"""obs-discipline rules: telemetry stays out of captured steps (the
reference package's ``analysis/obs_discipline.py``).

The obs/ plane's contract is host-boundary-only instrumentation. Inside
a captured step (a ``StepGraph`` body, a ``torch.cuda.graph`` block and
their resolvable callees, ``trace_safety.collect_traced``):

- ``obs-clock-in-trace``: a wall or monotonic clock read
  (``time.time``/``monotonic``/``perf_counter``/...) runs in the eager
  step and at capture, never at a replay — every replay of the graph
  reports nothing, and the one reading times the capture, not the step;
- ``obs-metrics-in-trace``: a metrics-registry, flight-recorder or span
  mutation (``.inc()``, ``.observe()``, anything in
  ``neuroimagedisttraining_tpu_torch.obs``) likewise runs at capture
  only: the counter moves by one forever after, whatever the replays do;
- ``obs-sync-in-trace``: ``torch.cuda.synchronize`` or an event's or
  stream's ``.synchronize()`` — the dispatch profiler (``obs/compute.py``)
  times the host around the launch and closes its windows at host
  boundaries that already synced, with zero added syncs, and a sync is
  illegal while a stream captures.

Lexical honesty: ``.set(...)`` is not flagged (the name is too generic:
``Tensor.set_``-like calls and dict-like setters abound); a gauge set
inside a step is still wrong, and is caught where it is spelled through
the obs package, as every call site of the tree spells it.

Two fan-in rules carry over as they are:

- ``obs-trace-ctx-key``: the wire trace context rides exactly ONE frame
  key, ``distributed.message.ARG_TRACE_CTX``; a ``msg.add("trace_ctx",
  ...)`` / ``msg.get("trace_ctx")`` spelled with the literal is flagged
  outside ``distributed/message.py``.
- ``obs-pipe-per-upload``: in ``asyncfl/ingest.py`` telemetry crosses the
  worker -> root pipe batched (``"vb"`` verdict batches, ``"beats"``,
  ``"obs"``); a per-upload ``conn.send(("v", ...))`` /
  ``conn.send(("beat", ...))`` is flagged.
"""

from __future__ import annotations

import ast
from typing import Iterator

from neuroimagedisttraining_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Rule,
    dotted_name,
    normalize,
    register,
)
from neuroimagedisttraining_tpu_torch.analysis.trace_safety import (
    calls_in_captured,
)

#: clock reads by canonical dotted name
CLOCK_DOTTED = {
    "time.time", "time.time_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "time.process_time", "time.process_time_ns",
    "time.thread_time", "time.thread_time_ns",
}

#: unambiguous registry-mutation method names (Counter.inc /
#: Histogram.observe); Gauge.set is excluded — see the module docstring
MUTATION_METHODS = {"inc", "observe"}

#: device syncs a dispatch timer must never put into a captured step:
#: ``torch.cuda.synchronize`` by dotted name and the zero-argument
#: ``Event.synchronize()`` / ``Stream.synchronize()``
SYNC_DOTTED = {"torch.cuda.synchronize"}
SYNC_METHODS = {"synchronize"}

#: any call into the obs package is telemetry
OBS_PREFIX = "neuroimagedisttraining_tpu_torch.obs"


@register
class ObsDisciplineRule(Rule):
    rule_ids = ("obs-clock-in-trace", "obs-metrics-in-trace",
                "obs-sync-in-trace")
    description = (
        "no wall/monotonic clock reads (obs-clock-in-trace), metrics-"
        "registry/flight/span mutation (obs-metrics-in-trace), or "
        "device syncs — torch.cuda.synchronize / Event.synchronize() / "
        "Stream.synchronize() (obs-sync-in-trace: dispatch timers live "
        "at host boundaries only) — lexically inside a captured step")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for node in calls_in_captured(mod):
            yield from self._check_call(mod, node)

    def _check_call(self, mod: ModuleInfo,
                    node: ast.Call) -> Iterator[Finding]:
        name = normalize(dotted_name(node.func), mod.aliases)
        if name in CLOCK_DOTTED:
            yield Finding(
                mod.path, node.lineno, "obs-clock-in-trace",
                f"{name} inside a captured step runs at capture and never "
                "at a replay — time at host boundaries only "
                "(obs/trace.py)")
            return
        if name in SYNC_DOTTED or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in SYNC_METHODS and not node.args):
            yield Finding(
                mod.path, node.lineno, "obs-sync-in-trace",
                "device sync inside a captured step: illegal while the "
                "graph captures, and exactly the hidden sync the dispatch "
                "profiler's zero-sync contract forbids (obs/compute.py) "
                "— sync and time at host boundaries only")
            return
        if name is not None and (name == OBS_PREFIX
                                 or name.startswith(OBS_PREFIX + ".")):
            yield Finding(
                mod.path, node.lineno, "obs-metrics-in-trace",
                f"{name} inside a captured step runs at capture only (a "
                "frozen counter / phantom flight event / a span of the "
                "capture) — instrument at host boundaries only")
            return
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in MUTATION_METHODS):
            yield Finding(
                mod.path, node.lineno, "obs-metrics-in-trace",
                f".{node.func.attr}() (metrics-registry mutation) "
                "inside a captured step runs at capture and never at a "
                "replay — publish at host boundaries only")


#: the single wire trace-context key (distributed.message.ARG_TRACE_CTX)
TRACE_CTX_LITERAL = "trace_ctx"

#: per-upload pipe-event spellings the batched protocol replaced
UNBATCHED_PIPE_KINDS = {"v", "beat"}


@register
class ObsFanInRule(Rule):
    """Wire-trace-context key discipline and batched-pipe telemetry
    discipline (module docstring)."""

    rule_ids = ("obs-trace-ctx-key", "obs-pipe-per-upload")
    description = (
        "trace context must ride the single ARG_TRACE_CTX constant "
        "(obs-trace-ctx-key: no 'trace_ctx' string literals in "
        ".add()/.get() outside distributed/message.py), and "
        "asyncfl/ingest.py telemetry pipe sends must be batched "
        "(obs-pipe-per-upload: no ('v', ...)/('beat', ...) events)")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        is_message_py = mod.path_parts[-2:] == ("distributed",
                                                "message.py")
        is_ingest_py = mod.path_parts[-2:] == ("asyncfl", "ingest.py")
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or \
                    not isinstance(node.func, ast.Attribute):
                continue
            if (not is_message_py and node.func.attr in ("add", "get")
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and node.args[0].value == TRACE_CTX_LITERAL):
                yield Finding(
                    mod.path, node.lineno, "obs-trace-ctx-key",
                    "the wire trace context rides exactly ONE frame "
                    "key — spell it M.ARG_TRACE_CTX "
                    "(distributed/message.py), not the string literal "
                    "(an ad-hoc key silently unlinks the flow chain)")
            if (is_ingest_py and node.func.attr == "send" and node.args
                    and isinstance(node.args[0], ast.Tuple)
                    and node.args[0].elts
                    and isinstance(node.args[0].elts[0], ast.Constant)
                    and node.args[0].elts[0].value
                    in UNBATCHED_PIPE_KINDS):
                kind = node.args[0].elts[0].value
                yield Finding(
                    mod.path, node.lineno, "obs-pipe-per-upload",
                    f"per-upload pipe event ({kind!r}) in the ingest "
                    "telemetry path — batch it (verdicts ride 'vb', "
                    "heartbeats 'beats', telemetry 'obs'): one pipe "
                    "send per upload was the fan-in's measured choke")


__all__ = ["ObsDisciplineRule", "ObsFanInRule", "CLOCK_DOTTED",
           "MUTATION_METHODS", "SYNC_DOTTED", "SYNC_METHODS",
           "TRACE_CTX_LITERAL", "UNBATCHED_PIPE_KINDS"]
