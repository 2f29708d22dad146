"""Seeded, resumable successive-halving search (the reference package's
``tune/search.py``).

The fidelity ladder is two rungs: every valid cell is SCREENED at a
cheap short window (``screen_fidelity`` rounds through the measurement
backend), the top ``survivors`` by score are RE-MEASURED at the
committed window (``commit_fidelity``), and the best refined cell is
the winner. Scores come from the live gauges the profiler already
publishes — ``nidt_mfu`` when a device peak is known, else
``nidt_sustained_tflops``, else the inverse round wall — and a cell
that recompile-storms (its graphs recaptured, ``obs/compute.py``) or
trips a critical health rule is scored FAILED (it loses the
tournament) rather than crashing the search.

The port's peak is per precision (``obs/compute.py`` ``PEAK_FLOPS``:
the card's fp32 cores against its bf16 tensor cores), so an MFU read
against each cell's own peak would rank a slower fp32 cell over a
faster bf16 one. A ``driver`` session therefore fixes ONE peak for all
of its cells, as the reference's session passes one
``NIDT_PEAK_FLOPS``: MFU is then FLOP/s over a constant and ranks
cells by throughput.

Determinism and resume:

- no wall-clock or RNG feeds a decision: the virtual backend derives
  its measurements from sha256(seed, cell fingerprint, fidelity), ties
  break on the fingerprint sort, and enumeration order is the space's
  declared order — same seed + space ⇒ same winner, same artifact
  bytes (the reference's bytes, pinned in tests/test_torch_tune.py);
- every measurement is keyed by ``(fingerprint, fidelity)`` in a JSONL
  journal flushed after each fresh measurement, so a killed run
  re-executed with the same journal path completes WITHOUT
  re-measuring finished cells.

Backends: :func:`virtual_measure` is the seeded deterministic cost
model the CPU harness commits artifacts with (it prices the same
effects the probes measure: bf16 step ratio, fused-tail saving,
dispatch amortization vs recompiles, mesh scaling, batch saturation);
:func:`make_driver_measure` runs the cell through the SHIPPED
``engine.train()`` driver via ``obs/probe.py`` — the card's backend.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Callable

from neuroimagedisttraining_tpu_torch.tune.space import Space, cell_fingerprint

__all__ = ["Journal", "run_search", "virtual_measure",
           "make_driver_measure", "score_of"]

#: a dispatch plan rebuilding this often within one short probe window
#: is thrashing — the same tripwire the recompile-storm health rule
#: uses (obs/rules.py)
RECOMPILE_STORM_DELTA = 3

MeasureFn = Callable[[dict, int, int], dict]


def score_of(metrics: dict) -> tuple[float | None, str]:
    """(score, metric name) from a measurement's metrics block: MFU
    when the peak is known, sustained TFLOP/s otherwise, inverse
    round-wall as the last resort (still higher-better)."""
    if metrics.get("mfu") is not None:
        return float(metrics["mfu"]), "mfu"
    if metrics.get("sustained_tflops") is not None:
        return float(metrics["sustained_tflops"]), "sustained_tflops"
    rms = metrics.get("round_ms")
    if rms:
        return 1000.0 / float(rms), "inv_round_ms"
    return None, "none"


class Journal:
    """Append-only JSONL measurement journal keyed by
    ``(fingerprint, fidelity)`` — the resume store. Each record is one
    completed measurement; a record is written (and flushed) only
    AFTER its measurement finishes, so a kill mid-measurement simply
    re-measures that cell on resume. A torn tail line (a kill mid-write)
    is skipped, and the next record starts on a line of its own."""

    def __init__(self, path: str):
        self.path = path
        self._done: dict[tuple[str, int], dict] = {}
        self._torn = False
        if os.path.exists(path):
            with open(path) as f:
                text = f.read()
            self._torn = bool(text) and not text.endswith("\n")
            for line in text.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail line of a killed run
                key = (rec.get("fingerprint"), int(rec.get("fidelity", 0)))
                if key[0]:
                    self._done[key] = rec

    def get(self, fingerprint: str, fidelity: int) -> dict | None:
        return self._done.get((fingerprint, int(fidelity)))

    def record(self, rec: dict) -> None:
        self._done[(rec["fingerprint"], int(rec["fidelity"]))] = rec
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a") as f:
            if self._torn:
                f.write("\n")
                self._torn = False
            f.write(json.dumps(rec, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def __len__(self) -> int:
        return len(self._done)


def virtual_measure(cell: dict, fidelity: int, seed: int) -> dict:
    """The seeded deterministic cost model. Derives a score from the
    cell alone plus sha256-seeded noise that SHRINKS with fidelity
    (short screens are noisier than committed windows — the property
    successive halving exists to exploit). Prices the measured
    effects: bf16's step ratio, the fused SGD tail, dispatch
    amortization, near-linear client-mesh scaling, batch saturation,
    and remat's recompute tax."""
    fp = cell_fingerprint(cell)
    h = hashlib.sha256(
        f"virtual:{int(seed)}:{fp}:{int(fidelity)}".encode()).digest()
    unit = int.from_bytes(h[:8], "big") / float(1 << 64)  # [0, 1)
    score = 1.0
    if cell.get("precision") == "bf16_mixed":
        score *= 1.55
    if cell.get("fused_update"):
        score *= 1.12
    rpd = int(cell.get("rounds_per_dispatch", 1))
    score *= 1.0 + 0.06 * (rpd - 1)
    cm = int(cell.get("client_mesh", 0))
    if cm > 1:
        score *= 1.0 + 0.45 * (cm - 1)
    batch = int(cell.get("batch", 8))
    score *= batch / (batch + 6.0)
    remat = cell.get("remat", "none")
    if remat == "stem":
        score *= 0.93
    elif remat in ("all", True):
        score *= 0.85
    score *= 1.0 + (unit - 0.5) * (0.12 / max(1, int(fidelity)))
    score = round(score, 6)
    return {
        "status": "ok", "reason": "",
        "score": score, "score_metric": "sustained_tflops",
        "metrics": {"mfu": None, "sustained_tflops": score,
                    "round_ms": round(120.0 / score, 3),
                    "dispatches": int(fidelity), "compiles": 1},
    }


def make_driver_measure(meta_overrides: dict | None = None,
                        device="cuda", virtual_devices: int = 0) -> MeasureFn:
    """The live backend: one closure holding the session federation so
    the search measures N cells against ONE seeded cohort on
    ``device``. Each call runs the cell through ``obs_probe.run_probe``
    (the shipped ``engine.train()`` driver) at ``fidelity`` rounds; a
    recompile storm or a critical health-rule verdict scores the cell
    FAILED, never crashes the search.

    The session's ONE peak: ``NIDT_PEAK_FLOPS``, else the card's
    ``bf16_mixed`` peak (the highest the card offers), set as the
    profiler's override for every cell; the closure's ``peak_flops``
    attribute records it (None: no known peak, as on the CPU, and each
    cell's engine arms its own). Each measurement's metrics also carry the
    cell's kernel launches, local steps and, on a card, its peak
    memory reserved."""
    import torch

    from neuroimagedisttraining_tpu_torch.device import resolve_device
    from neuroimagedisttraining_tpu_torch.obs import compute as obs_compute
    from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
    from neuroimagedisttraining_tpu_torch.obs import probe as obs_probe
    from neuroimagedisttraining_tpu_torch.obs import rules as obs_rules

    dev = resolve_device(device)
    base_meta = dict(obs_probe._env_meta())
    base_meta.update(meta_overrides or {})
    fed = obs_probe._make_fed(base_meta, dev)
    entries = obs_probe.mesh_entries(dev, virtual_devices)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak_flops = obs_compute.peak_flops_estimate("bf16_mixed", name)
    if peak_flops > 0:
        obs_compute.PROFILER.set_peak_flops(peak_flops)

    def measure(cell: dict, fidelity: int, seed: int) -> dict:
        meta = dict(base_meta, rounds=int(fidelity))
        probe = obs_probe.Probe(f"tune-{cell_fingerprint(cell)}",
                                dict(cell))
        before = obs_compute.PROFILER.health().get("recompiles", 0)
        try:
            res = obs_probe.run_probe(probe, meta, fed, dev, entries)
        except Exception as e:  # noqa: BLE001 — failed cell, not a
            # crashed search: the tournament continues and the journal
            # records why this cell lost
            return {"status": "failed",
                    "reason": f"error: {type(e).__name__}: {e}",
                    "score": None, "score_metric": "none",
                    "metrics": {}}
        if not res.get("ran"):
            return {"status": "failed",
                    "reason": res.get("skip_reason") or "did not run",
                    "score": None, "score_metric": "none",
                    "metrics": {}}
        recompiles = (obs_compute.PROFILER.health().get("recompiles", 0)
                      - before)
        metrics = {"mfu": res.get("mfu"),
                   "sustained_tflops": res.get("sustained_tflops"),
                   "round_ms": res.get("round_ms"),
                   "dispatches": res.get("dispatches"),
                   "compiles": res.get("compiles"),
                   "recompiles": int(recompiles),
                   "local_steps": res["step_replays"] + res["compiles"],
                   "launches": res["launches"],
                   "peak_reserved_bytes": (res.get("memory") or {}).get(
                       "peak_reserved_bytes")}
        if recompiles >= RECOMPILE_STORM_DELTA:
            return {"status": "failed", "reason": "recompile-storm",
                    "score": None, "score_metric": "none",
                    "metrics": metrics}
        gate = obs_rules.RuleEngine(obs_rules.builtin_rules())
        gate.observe(10 ** 9, obs_metrics.REGISTRY.snapshot())
        if gate.health_block()["status"] == "critical":
            return {"status": "failed", "reason": "health-gate-red",
                    "score": None, "score_metric": "none",
                    "metrics": metrics}
        score, metric = score_of(metrics)
        if score is None:
            return {"status": "failed", "reason": "no score sample",
                    "score": None, "score_metric": "none",
                    "metrics": metrics}
        return {"status": "ok", "reason": "", "score": score,
                "score_metric": metric, "metrics": metrics}

    measure.peak_flops = peak_flops or None
    return measure


def _measure_keyed(cell: dict, fidelity: int, seed: int,
                   measure: MeasureFn, journal: Journal | None,
                   counters: dict) -> dict:
    fp = cell_fingerprint(cell)
    if journal is not None:
        prior = journal.get(fp, fidelity)
        if prior is not None:
            counters["reused"] += 1
            return prior
    m = measure(cell, int(fidelity), int(seed))
    rec = {"fingerprint": fp, "cell": dict(cell),
           "fidelity": int(fidelity), **m}
    counters["fresh"] += 1
    if journal is not None:
        journal.record(rec)
    return rec


def run_search(space: Space, seed: int, measure: MeasureFn,
               journal: Journal | None = None, *,
               screen_fidelity: int = 2, commit_fidelity: int = 5,
               survivors: int = 4, log=print) -> dict[str, Any]:
    """Screen every valid cell at ``screen_fidelity``, re-measure the
    top ``survivors`` at ``commit_fidelity``, return the full result
    document (winner + both rungs' traces + the rejected cells). A
    journal makes the whole thing resumable; without one the search is
    purely in-memory (the determinism self-check's mode)."""
    if screen_fidelity < 1 or commit_fidelity < screen_fidelity:
        raise ValueError(
            f"fidelity ladder must satisfy 1 <= screen <= commit (got "
            f"screen={screen_fidelity}, commit={commit_fidelity})")
    if survivors < 1:
        raise ValueError(f"survivors must be >= 1 (got {survivors})")
    cells, rejected = space.cells()
    if not cells:
        raise ValueError(
            "the space has no valid cells (every combination was "
            "rejected by the validity predicates)")
    counters = {"fresh": 0, "reused": 0}
    screened = [_measure_keyed(c, screen_fidelity, seed, measure,
                               journal, counters) for c in cells]
    ok = [m for m in screened if m["status"] == "ok"]
    if not ok:
        raise ValueError(
            "every screened cell failed — no survivor to refine "
            "(see the journal/session trace for per-cell reasons)")
    ok.sort(key=lambda m: (-m["score"], m["fingerprint"]))
    finalists = ok[:max(1, min(survivors, len(ok)))]
    log(f"[tune] screened {len(screened)} cells "
        f"({len(screened) - len(ok)} failed, "
        f"{counters['reused']} from journal); refining "
        f"{len(finalists)} at {commit_fidelity} rounds")
    refined = [_measure_keyed(m["cell"], commit_fidelity, seed, measure,
                              journal, counters) for m in finalists]
    ok_refined = [m for m in refined if m["status"] == "ok"]
    if not ok_refined:
        raise ValueError("every refined survivor failed at the "
                         "committed window")
    ok_refined.sort(key=lambda m: (-m["score"], m["fingerprint"]))
    winner = ok_refined[0]
    log(f"[tune] winner {winner['fingerprint']} "
        f"score={winner['score']} ({winner['score_metric']}): "
        f"{winner['cell']}")
    return {
        "winner": winner,
        "screened": screened,
        "refined": refined,
        "rejected": rejected,
        "n_cells": len(cells),
        "screen_fidelity": int(screen_fidelity),
        "commit_fidelity": int(commit_fidelity),
        "survivors": int(survivors),
        "seed": int(seed),
        "fresh_measurements": counters["fresh"],
        "journal_reused": counters["reused"],
        "space_fingerprint": space.fingerprint(),
    }
