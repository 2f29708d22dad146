"""The dispatch-boundary profiler (the reference package's
``obs/compute.py``), for the port's rounds, windows and CUDA graphs.

- **Dispatch time** (``nidt_dispatch_ms{engine, program, phase}``): the
  host's wall time around each round's or window's dispatch
  (``engines/base.py`` ``run_rounds``) and around each graph replay and
  capture (``core/graphs.py``). The host queues the card's work, so this
  is queueing time (and a capture's time on ``phase="compile"``), never
  device time, and no sync is added to take it.
- **Captures** (``nidt_compiles_total{engine, program}``): a graph
  capture is the port's compile, the same increment that
  ``RoundProgram.built`` counts; a capture of a configuration already
  captured before (graphs dropped by a rollback, an escalation or a
  mesh shrink) also counts in ``nidt_recompiles_total``.
- **MFU** (``nidt_mfu{engine}``, ``nidt_sustained_tflops{engine}``): the
  analytic training FLOPs (``ops/flops.py``) of the rounds dispatched
  since the last host boundary over the wall time between boundaries
  (``FederatedEngine.publish_stat_info``, where the host has already
  read the round's outputs), never over queueing time. The peak is
  :data:`PEAK_FLOPS` by device kind and precision; ``NIDT_PEAK_FLOPS``
  and ``--peak_flops`` override it; a device with no entry (the CPU)
  publishes TFLOP/s only.
- **The FLOP counts' reconciliation** (:func:`analyze_train_step`): one
  training step under ``torch.utils.flop_counter.FlopCounterMode``
  against the analytic count (``nidt_xla_flops`` holds the counter's
  FLOPs, ``nidt_flops_parity_ratio`` the ratio) and the step's peak
  memory (``torch.cuda.max_memory_allocated``,
  ``nidt_hbm_peak_bytes{kind}``). Not on the training path.

``/healthz``'s ``compute`` block is :meth:`ComputeProfiler.health`: the
last dispatch's age, the last MFU sample, the capture counts. Nothing
here touches a device tensor, so a run with the profiler is bit for bit
a run without it.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any

from neuroimagedisttraining_tpu_torch.obs import flight as obs_flight
from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
from neuroimagedisttraining_tpu_torch.obs import names as N

__all__ = [
    "ComputeProfiler", "PROFILER", "note_compile", "note_dispatch",
    "boundary", "arm_model", "health", "compiles_total", "PEAK_FLOPS",
    "peak_flops_estimate", "analyze_train_step", "analytic_sample_flops",
]

log = logging.getLogger("neuroimagedisttraining_tpu_torch.obs")

#: dense peak flop/s of one card by (device-name prefix, precision), the
#: vendor's figures: the H100 SXM5's CUDA cores run the fp32 contract
#: (TF32 off, ``device.py``), its tensor cores ``bf16_mixed``; the first
#: prefix that matches wins
PEAK_FLOPS: tuple[tuple[str, str, float], ...] = (
    ("NVIDIA H100 PCIe", "fp32", 51.2e12),
    ("NVIDIA H100 PCIe", "bf16_mixed", 756.0e12),
    ("NVIDIA H100", "fp32", 66.9e12),
    ("NVIDIA H100", "bf16_mixed", 989.4e12),
)

#: ``nidt_dispatch_ms`` buckets (milliseconds): sub-ms queueing through
#: minute-long first calls
DISPATCH_MS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                       100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                       10000.0, 30000.0, 120000.0)

#: recapture warnings a process logs (the counter and the flight ring
#: keep the full count)
_MAX_STORM_WARNINGS = 8


def peak_flops_estimate(precision: str = "fp32", device_name: str | None
                        = None, cards: int = 1) -> float:
    """The MFU denominator, flop/s: ``NIDT_PEAK_FLOPS`` (the total), else
    :data:`PEAK_FLOPS` of ``device_name`` (default: card 0's name) and
    ``precision`` times ``cards``, else 0.0 (no known peak: the CPU)."""
    env = os.environ.get("NIDT_PEAK_FLOPS", "")
    if env:
        try:
            return float(env)
        except ValueError:
            log.warning("NIDT_PEAK_FLOPS=%r is not a number; ignoring",
                        env)
    if device_name is None:
        try:
            import torch

            if not torch.cuda.is_available():
                return 0.0
            device_name = torch.cuda.get_device_name(0)
        except Exception:  # noqa: BLE001 — no device is a valid state
            return 0.0
    for prefix, prec, per_card in PEAK_FLOPS:
        if device_name.startswith(prefix) and prec == precision:
            return per_card * max(1, int(cards))
    return 0.0


class ComputeProfiler:
    """One process's dispatch-boundary accounting (:data:`PROFILER`): fed
    by the engines' dispatches and the step graphs, closed at the
    engines' host boundaries."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        """Back to the cold state (tests)."""
        with getattr(self, "_lock", threading.Lock()):
            self._armed_engine: str | None = None
            self._flops_per_round = 0.0
            self._peak_flops = 0.0
            self._peak_override = 0.0
            self._total_compiles = 0
            self._total_recompiles = 0
            self._total_dispatches = 0
            self._storm_warnings = 0
            self._last_dispatch_mono: float | None = None
            self._last_compile_s: float | None = None
            self._boundary_mono: float | None = None
            self._rounds_pending = 0
            self._dispatch_s_pending = 0.0
            self._last_mfu: float | None = None
            self._last_tflops: float | None = None

    # ---------- arming (analytic FLOPs and the peak) ----------

    def arm_model(self, engine: str, flops_per_round: float,
                  peak_flops: float | None = None, precision: str = "fp32",
                  device_name: str | None = None) -> None:
        """Arm ``engine``'s MFU accounting: ``flops_per_round`` is the
        analytic training FLOPs of one round at the nominal cohort;
        ``peak_flops`` defaults to the ``--peak_flops`` override, else
        :func:`peak_flops_estimate` of ``precision`` on ``device_name``
        (default: card 0). A later arm (another engine in the process)
        starts a new measurement."""
        with self._lock:
            self._armed_engine = engine
            self._flops_per_round = float(flops_per_round)
            if peak_flops is not None:
                self._peak_flops = float(peak_flops)
            elif self._peak_override > 0:
                self._peak_flops = self._peak_override
            else:
                self._peak_flops = peak_flops_estimate(precision,
                                                       device_name)
            self._boundary_mono = time.monotonic()
            self._rounds_pending = 0
            self._dispatch_s_pending = 0.0
            self._last_mfu = None
            self._last_tflops = None

    def set_peak_flops(self, peak_flops: float) -> None:
        """``--peak_flops``: kept across later arms; 0 keeps the table's."""
        if peak_flops and peak_flops > 0:
            with self._lock:
                self._peak_override = float(peak_flops)
                self._peak_flops = self._peak_override

    # ---------- the dispatch boundary ----------

    def note_compile(self, engine: str, program: str,
                     recompile: bool = False) -> None:
        """One graph capture; ``recompile``: a configuration captured
        before is captured again (its graph was dropped)."""
        obs_metrics.counter(
            N.COMPILES_TOTAL,
            "CUDA graph captures of local-step configurations by engine "
            "and program (core/graphs.py); a configuration captured more "
            "than once mid-run is a recapture storm",
            labelnames=("engine", "program")).labels(
            engine=engine, program=program).inc()
        with self._lock:
            self._total_compiles += 1
            if recompile:
                self._total_recompiles += 1
                warn = self._storm_warnings < _MAX_STORM_WARNINGS
                self._storm_warnings += 1
                n = self._total_recompiles
        if recompile:
            obs_metrics.counter(
                N.RECOMPILES_TOTAL,
                "mid-run recaptures of a step configuration captured "
                "before (graphs dropped and captured again)",
                labelnames=("engine", "program")).labels(
                engine=engine, program=program).inc()
            obs_flight.record("recompile", engine=engine,
                              program=program, total=n)
            if warn:
                log.warning(
                    "compute: step %s/%s captured again mid-run "
                    "(recapture #%d this process): its graphs were "
                    "dropped (nidt_recompiles_total; the flight ring has "
                    "the event)", engine, program, n)

    def note_dispatch(self, engine: str, program: str, dur_s: float,
                      rounds: int = 0, phase: str = "execute") -> None:
        """One dispatch: ``dur_s`` is the host's wall time around it
        (queueing; a capture on ``phase="compile"``), ``rounds`` the
        rounds it carries (a window's K; 0 for a graph replay inside a
        round), which the MFU numerator adds up until the next
        boundary."""
        obs_metrics.histogram(
            N.DISPATCH_MS,
            "host wall time a dispatch (obs/compute.py): a round or "
            "window on program=\"round\"/\"window\", a local step's "
            "graph replay on program=\"step\"; phase=\"compile\" is a "
            "capture (the card's time is on the profiler's timeline)",
            labelnames=("engine", "program", "phase"),
            buckets=DISPATCH_MS_BUCKETS).labels(
            engine=engine, program=program, phase=phase).observe(
            dur_s * 1e3)
        with self._lock:
            self._total_dispatches += 1
            self._last_dispatch_mono = time.monotonic()
            if phase == "compile":
                self._last_compile_s = float(dur_s)
            if engine == self._armed_engine:
                self._rounds_pending += int(rounds)
                self._dispatch_s_pending += float(dur_s)

    def boundary(self, engine: str) -> float | None:
        """Close one boundary-to-boundary window and publish the gauges:
        the host has read the round's outputs here, so the rounds
        dispatched since the last boundary have finished. Returns the MFU
        sample (None unarmed, with no known peak, or on an empty
        window)."""
        now = time.monotonic()
        with self._lock:
            if engine != self._armed_engine or self._boundary_mono is None:
                return None
            wall = now - self._boundary_mono
            rounds = self._rounds_pending
            self._boundary_mono = now
            self._rounds_pending = 0
            self._dispatch_s_pending = 0.0
            if rounds <= 0 or wall <= 0 or self._flops_per_round <= 0:
                return None
            flops_s = rounds * self._flops_per_round / wall
            self._last_tflops = flops_s / 1e12
            mfu = (flops_s / self._peak_flops
                   if self._peak_flops > 0 else None)
            self._last_mfu = mfu
        obs_metrics.gauge(
            N.SUSTAINED_TFLOPS,
            "sustained analytic training TFLOP/s over the last host-"
            "boundary window (ops/flops.py numerator over the wall time)",
            labelnames=("engine",)).labels(engine=engine).set(
            self._last_tflops)
        if mfu is not None:
            obs_metrics.gauge(
                N.MFU,
                "model FLOPs utilization over the last host-boundary "
                "window: analytic training FLOP/s over the card's peak "
                "(obs/compute.py PEAK_FLOPS; NIDT_PEAK_FLOPS / "
                "--peak_flops override)",
                labelnames=("engine",)).labels(engine=engine).set(mfu)
        return mfu

    # ---------- liveness (the /healthz compute block) ----------

    def health(self) -> dict:
        """The ``/healthz`` ``compute`` block: a stalled run shows a
        growing ``last_dispatch_age_s`` with counts that stand still."""
        with self._lock:
            age = (None if self._last_dispatch_mono is None
                   else round(time.monotonic() - self._last_dispatch_mono,
                              3))
            return {
                "last_dispatch_age_s": age,
                "dispatches": self._total_dispatches,
                "compiles": self._total_compiles,
                "recompiles": self._total_recompiles,
                "last_compile_s": self._last_compile_s,
                "last_mfu": self._last_mfu,
                "last_sustained_tflops": self._last_tflops,
                "peak_flops": self._peak_flops or None,
                "armed_engine": self._armed_engine,
            }


#: the process-global profiler
PROFILER = ComputeProfiler()

#: module-level conveniences (instrumentation-site spelling)
note_compile = PROFILER.note_compile
note_dispatch = PROFILER.note_dispatch
boundary = PROFILER.boundary
arm_model = PROFILER.arm_model
health = PROFILER.health


def compiles_total(engine: str | None = None,
                   program: str | None = None) -> float:
    """The sum of the ``nidt_compiles_total`` cells matching the
    filters."""
    snap = obs_metrics.REGISTRY.snapshot().get(N.COMPILES_TOTAL)
    if not snap:
        return 0.0
    total = 0.0
    for cell in snap["values"]:
        lb = cell["labels"]
        if engine is not None and lb.get("engine") != engine:
            continue
        if program is not None and lb.get("program") != program:
            continue
        total += float(cell["value"])
    return total


# ---------------------------------------------------------------------------
# the FLOP counts' reconciliation (not on the training path)
# ---------------------------------------------------------------------------


def analytic_sample_flops(trainer, sample_shape: tuple[int, ...],
                          mask_density: dict | None = None) -> float:
    """Analytic training FLOPs of one sample (``ops/flops.py``: 3x the
    inference FLOPs, exact for fixed shapes; shapes traced on the meta
    device, no weights touched)."""
    from neuroimagedisttraining_tpu_torch.ops import flops as flops_ops

    return flops_ops.count_training_flops_per_sample(
        trainer.model, tuple(sample_shape), mask_density)


def analyze_train_step(trainer, params, bstats, x, y, *,
                       publish: bool = True) -> dict:
    """One training step of ``trainer`` (``loss_and_grad`` on the batch
    ``x``, ``y``) under ``FlopCounterMode``, against the analytic count of
    its ``x.shape[0]`` samples; on a card, the step's peak memory. The
    counter sees the aten operators, so a kernel of ``csrc/`` that
    replaces one (the stem's weight gradient under ``NIDT_FAST_STEM``) is
    not in its count: give a trainer without it for the whole step.

    Returns ``{"counter_flops", "analytic_flops", "parity_ratio",
    "batch_size", "peak_bytes"}``; ``publish`` sets ``nidt_xla_flops``,
    ``nidt_flops_parity_ratio`` and ``nidt_hbm_peak_bytes``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    dev = x.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    counter = FlopCounterMode(display=False)
    with counter:
        trainer.loss_and_grad(params, bstats, x, y)
    peak = None
    if cuda:
        torch.cuda.synchronize(dev)
        peak = int(torch.cuda.max_memory_allocated(dev))
    counted = float(counter.get_total_flops())
    shape = tuple(x.shape[1:])
    analytic = analytic_sample_flops(trainer, shape) * int(x.shape[0])
    ratio = counted / analytic if counted and analytic > 0 else None
    out: dict[str, Any] = {
        "batch_size": int(x.shape[0]), "counter_flops": counted,
        "analytic_flops": analytic,
        "parity_ratio": round(ratio, 4) if ratio is not None else None,
        "peak_bytes": peak}
    if publish:
        obs_metrics.gauge(
            N.XLA_FLOPS,
            "FlopCounterMode FLOPs of one training step "
            "(obs/compute.py analyze_train_step)").set(counted)
        if ratio is not None:
            obs_metrics.gauge(
                N.FLOPS_PARITY_RATIO,
                "FlopCounterMode FLOPs over the analytic ops/flops.py "
                "count for one training step").set(ratio)
        if peak is not None:
            obs_metrics.gauge(
                N.HBM_PEAK_BYTES,
                "peak device memory of one training step by kind "
                "(torch.cuda.max_memory_allocated)",
                labelnames=("kind",)).labels(kind="peak").set(peak)
    return out
