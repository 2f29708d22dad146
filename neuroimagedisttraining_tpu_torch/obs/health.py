"""Training-health publication: the host side of the round's federation
statistics (the reference package's ``obs/health.py``).

Under ``--health_stats`` the round's tail computes, on the device, the
per-client update L2 norms, each client's leave-one-out cosine to the
aggregate, the dispersion of the norms, the norms of the global model and
of the aggregate update, and the masked engines' mask statistics
(``engines/program.py`` ``health_update_stats`` / ``mask_health_stats``).
They ride out with the round's outputs and are read in the same
``read_host`` call (one device read a round, or a window), so arming them
adds no sync and changes no bit of training.

This module is what happens after the read: each round's host scalars
become ``nidt_health_*`` gauges (and the per-client norm histogram),
labeled by engine. The names live in ``obs/names.py``; the rules that
judge these series in ``obs/rules.py``. Host boundaries only.
"""

from __future__ import annotations

import math
from typing import Any, Iterable, Mapping

import numpy as np

from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
from neuroimagedisttraining_tpu_torch.obs import names as N

__all__ = [
    "UPDATE_STAT_NAMES", "MASK_STAT_NAMES", "publish_round_stats",
    "publish_mask_density", "fallback_block", "health_gauge",
    "UPDATE_NORM_BUCKETS",
]

#: the stats of a round whose engine holds a global model, in order
UPDATE_STAT_NAMES: tuple[str, ...] = (
    "h_up_norms",    # [C] per-client update L2 norms vs the broadcast
    "h_up_max",      # max over clients
    "h_up_med",      # median over clients
    "h_cos_min",     # min leave-one-out cosine: client update vs the
                     # aggregate minus its own weighted contribution
                     # (self-mass would flip a sign-flipper back to +)
    "h_cos_mean",    # mean leave-one-out cosine over the cohort
    "h_disp",        # dispersion: max norm / median norm
    "h_gnorm",       # L2 norm of the NEW global params
    "h_agg_up",      # L2 norm of the aggregated update (the round's
                     # pseudo-gradient — "global grad norm" at the
                     # server, where per-example grads never exist)
    "h_cos",         # [C] per-client leave-one-out cosine vector:
                     # no gauge of its own; the quarantine handler
                     # reads it on the host to name the sampled client
                     # a divergence alert is about (engines/base.py)
)

#: the mask stats of the masked engines (SalientGrads, Sub-FedAvg)
MASK_STAT_NAMES: tuple[str, ...] = (
    "h_mask_density",   # mean kept fraction over clients
    "h_mask_overlap",   # round-over-round kept-weight overlap
    "h_mask_churn",     # 1 - overlap
)

#: buckets for the per-client update-norm histogram: spans collapsed
#: (~1e-6) through diverged (~1e3) updates on the flagship models
UPDATE_NORM_BUCKETS = (1e-6, 1e-4, 1e-3, 1e-2, 0.1, 0.25, 0.5, 1.0,
                       2.5, 5.0, 10.0, 25.0, 100.0, 1000.0)

#: stat-name -> (metric name, help) for the scalar gauges
_GAUGE_OF: dict[str, tuple[str, str]] = {
    "h_up_max": (N.HEALTH_UPDATE_NORM_MAX,
                 "max per-client update L2 norm of the round"),
    "h_up_med": (N.HEALTH_UPDATE_NORM_MED,
                 "median per-client update L2 norm of the round"),
    "h_cos_min": (N.HEALTH_COSINE_MIN,
                  "min leave-one-out cosine: each client's update vs "
                  "the aggregated update minus its own contribution "
                  "(a sign-flipping silo reads strongly negative "
                  "here; self-inclusion would mask it)"),
    "h_cos_mean": (N.HEALTH_COSINE_MEAN,
                   "mean leave-one-out cosine of client updates to "
                   "the aggregated update"),
    "h_disp": (N.HEALTH_DIVERGENCE,
               "update-norm dispersion: max / median client update "
               "norm (non-IID divergence blows this up before the "
               "loss shows it)"),
    "h_gnorm": (N.HEALTH_PARAM_NORM,
                "L2 norm of the aggregated global params"),
    "h_agg_up": (N.HEALTH_AGG_UPDATE_NORM,
                 "L2 norm of the aggregated update (the server-side "
                 "pseudo-gradient)"),
    "h_mask_density": (N.HEALTH_MASK_DENSITY,
                       "mean kept fraction of the engine's "
                       "pruning/saliency masks"),
    "h_mask_overlap": (N.HEALTH_MASK_OVERLAP,
                       "round-over-round kept-weight overlap of the "
                       "engine's masks"),
    "h_mask_churn": (N.HEALTH_MASK_CHURN,
                     "round-over-round mask churn (1 - overlap); a "
                     "NaN-poisoned fire/regrow shows as a churn spike "
                     "then a dead mask"),
}


def health_gauge(name: str, help: str) -> obs_metrics.Gauge:
    """An engine-labeled health gauge (idempotent registration)."""
    return obs_metrics.gauge(name, help, labelnames=("engine",))


def _finite(v: Any) -> float | None:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


def publish_round_stats(engine: str, round_idx: int,
                        stats: Mapping[str, Any]) -> None:
    """Publish ONE drained round's host-side stats into the registry.

    ``stats`` maps stat names (``h_*``) to host numpy values — scalars
    for the gauges, the ``[C]`` per-client norm vector for the
    histogram. Values that came back non-finite (a diverged round) are
    still published: NaN in a gauge is itself the signal the
    ``update-norm-collapse``/divergence rules react to via their
    comparator semantics (NaN fails every comparison, so a rule never
    fires ON NaN — the non-finite guard's ``n_bad`` path carries that
    story instead)."""
    for key, v in stats.items():
        if key == "h_up_norms":
            h = obs_metrics.histogram(
                N.HEALTH_UPDATE_NORM,
                "per-client update L2 norms vs the round's broadcast "
                "model (one observe per client per round)",
                labelnames=("engine",), buckets=UPDATE_NORM_BUCKETS)
            for x in np.ravel(np.asarray(v)):
                fx = _finite(x)
                if fx is not None:
                    h.labels(engine=engine).observe(fx)
            continue
        meta = _GAUGE_OF.get(key)
        if meta is None:
            continue  # engine-private stat without a declared gauge
        f = _finite(v)
        health_gauge(*meta).labels(engine=engine).set(
            f if f is not None else float("nan"))
    obs_metrics.gauge(
        N.HEALTH_ROUND,
        "last round whose in-dispatch health stats were published",
        labelnames=("engine",)).labels(engine=engine).set(int(round_idx))


def publish_mask_density(engine: str, round_idx: int,
                         density: float) -> None:
    """Mask density of an engine whose masks evolve outside a declared
    round (DisPFL): published from ``warn_if_masks_collapsed``, whose
    count of kept entries is the measurement."""
    f = _finite(density)
    health_gauge(*_GAUGE_OF["h_mask_density"]).labels(
        engine=engine).set(f if f is not None else float("nan"))
    obs_metrics.gauge(
        N.HEALTH_ROUND,
        "last round whose in-dispatch health stats were published",
        labelnames=("engine",)).labels(engine=engine).set(int(round_idx))


def fallback_block(snapshot: dict | None = None) -> dict:
    """The ``/healthz`` fast-path-coverage block:
    ``nidt_fallback_total{plane, engine, reason}`` totals beside the
    compute block, so a run that fell back to one round at a time or to
    the unsharded round reads differently from one that did not.
    ``snapshot`` defaults to the process registry."""
    snap = (snapshot if snapshot is not None
            else obs_metrics.REGISTRY.snapshot())
    m = snap.get(N.FALLBACK_TOTAL) or {}
    rows: list[dict] = []
    by_plane: dict[str, float] = {}
    for cell in m.get("values", ()):
        lb = cell.get("labels", {})
        n = float(cell.get("value", 0.0))
        rows.append({"plane": lb.get("plane", ""),
                     "engine": lb.get("engine", ""),
                     "reason": lb.get("reason", ""), "count": n})
        by_plane[lb.get("plane", "")] = (
            by_plane.get(lb.get("plane", ""), 0.0) + n)
    return {"total": sum(by_plane.values()), "by_plane": by_plane,
            "announcements": rows}


def stat_names_for(carry: Iterable[str],
                   extra: tuple[str, ...] = ()) -> tuple[str, ...]:
    """The health stats of a declared round: the update stats where the
    carry holds the global model (``params`` and ``batch_stats``), plus
    the engine's own (mask health). Engines without a global model
    (Local, D-PSGD) have no broadcast reference to measure updates
    against."""
    names: tuple[str, ...] = ()
    if {"params", "batch_stats"} <= set(carry):
        names = UPDATE_STAT_NAMES
    return names + tuple(extra)
