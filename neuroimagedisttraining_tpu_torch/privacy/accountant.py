"""RDP (moments) accountant for the DP noise paths.

Abadi et al. 2016 introduced the moments accountant: track the privacy
loss of a composed mechanism through its Renyi-divergence moments
instead of naive (epsilon, delta) composition; Mironov 2017 recast the
same bookkeeping as Renyi Differential Privacy — an additive accountant
over a grid of orders alpha, converted to (epsilon, delta) once at
report time. This module is that accountant for the two noise paths the port
ships (a copy of the reference package's ``privacy/accountant.py``):

- the ``weak_dp`` defense (clip to ``norm_bound``, add per-client
  Gaussian noise ``stddev`` — core/robust.py), and
- the ``dpsgd`` engine's round-level clip+noise on each client's local
  update (``--dp_clip`` / ``--dp_sigma``).

Math (pure numpy and the standard library; the accountant runs on the
host):

- Subsampled Gaussian mechanism, integer orders alpha >= 2
  (Mironov et al. 2019, the standard integer-order expansion the
  moments accountant evaluates):
    RDP(alpha) = 1/(alpha-1) * log( sum_{k=0..alpha} C(alpha,k)
                 (1-q)^(alpha-k) q^k exp((k^2-k)/(2 sigma^2)) )
  evaluated in log space (logsumexp + lgamma) so sigma < 1 and
  alpha ~ 512 stay finite.
- q = 1 (full participation) collapses to the Gaussian mechanism's
  closed form RDP(alpha) = alpha / (2 sigma^2) — the single-round
  reference the tests pin the expansion against.
- Composition is ADDITIVE in RDP: T rounds cost T * RDP(alpha).
- Conversion (Mironov 2017, Prop. 3):
    epsilon(delta) = min over alpha of RDP(alpha) + log(1/delta)/(alpha-1).

Noise-multiplier normalization: RDP formulas are stated for noise
sigma * sensitivity. ``weak_dp`` adds ABSOLUTE noise ``stddev`` to each
client's update clipped to ``norm_bound`` and then takes a weighted
mean, so the effective multiplier depends on the weights —
``weak_dp_noise_multiplier`` computes it exactly:
noise on the weighted mean has std ``stddev * sqrt(sum w^2) / W`` while
one client's clipped contribution moves it by at most
``norm_bound * max(w) / W``, giving
z = stddev * sqrt(sum w^2) / (norm_bound * max(w)).
(Uniform weights: z = stddev * sqrt(C) / norm_bound.)
"""

from __future__ import annotations

import math

import numpy as np

#: default Renyi order grid: dense integers where the minimum usually
#: lands, sparse large orders for very small epsilon regimes
DEFAULT_ORDERS: tuple[int, ...] = tuple(range(2, 65)) + (
    80, 96, 128, 192, 256, 384, 512)


def _log_binom(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1)
            - math.lgamma(n - k + 1))


def _logsumexp(vals: np.ndarray) -> float:
    m = float(np.max(vals))
    if not math.isfinite(m):
        return m
    return m + math.log(float(np.sum(np.exp(vals - m))))


def rdp_gaussian(q: float, noise_multiplier: float,
                 orders=DEFAULT_ORDERS) -> np.ndarray:
    """Per-step RDP of the subsampled Gaussian mechanism at every order.

    ``q``: sampling rate in [0, 1]; ``noise_multiplier``: noise sigma in
    units of the mechanism's sensitivity. Orders must be integers >= 2
    (the grid is validated — a float order would silently evaluate the
    integer expansion at the wrong alpha).
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"sampling rate q must be in [0, 1], got {q}")
    if not (math.isfinite(noise_multiplier) and noise_multiplier > 0):
        # NaN fails the > comparison too: a poisoned multiplier must
        # raise here, never surface as "epsilon": NaN in a privacy audit
        raise ValueError(
            f"noise_multiplier must be finite and > 0, got "
            f"{noise_multiplier} (sigma == 0 is not a DP mechanism — "
            "epsilon is infinite)")
    orders = np.asarray(orders)
    if not np.all(orders == orders.astype(int)) or np.any(orders < 2):
        raise ValueError(f"orders must be integers >= 2, got {orders}")
    s2 = float(noise_multiplier) ** 2
    if q == 0.0:
        return np.zeros(len(orders), np.float64)
    if q == 1.0:
        # Gaussian mechanism closed form — also the tests' single-round pin
        return orders.astype(np.float64) / (2.0 * s2)
    out = np.empty(len(orders), np.float64)
    logq, log1q = math.log(q), math.log1p(-q)
    for i, a in enumerate(int(a) for a in orders):
        terms = np.asarray([
            _log_binom(a, k) + k * logq + (a - k) * log1q
            + (k * k - k) / (2.0 * s2)
            for k in range(a + 1)])
        out[i] = _logsumexp(terms) / (a - 1)
    return out


def rdp_to_epsilon(rdp: np.ndarray, orders=DEFAULT_ORDERS,
                   delta: float = 1e-5) -> tuple[float, int]:
    """(epsilon, best_order): the tightest (epsilon, delta) the RDP curve
    certifies (Mironov 2017 Prop. 3)."""
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    orders = np.asarray(orders, np.float64)
    eps = np.asarray(rdp, np.float64) + math.log(1.0 / delta) / (orders - 1)
    i = int(np.argmin(eps))
    return float(eps[i]), int(orders[i])


def validate_weights(weights) -> np.ndarray:
    """THE aggregation-weight validator the privacy plane shares (the
    epsilon report and the field-fold weights both ride on it): finite,
    non-negative, max > 0 — a NaN weight fails every comparison
    silently, so it must raise here, not skew arithmetic downstream."""
    w = np.asarray(weights, np.float64)
    if w.size == 0 or not np.all(np.isfinite(w)) or np.any(w < 0) \
            or float(np.max(w)) <= 0:
        raise ValueError(
            f"weights must be finite, non-negative, with max > 0: {w}")
    return w


def weak_dp_noise_multiplier(stddev: float, norm_bound: float,
                             weights) -> float:
    """Effective noise multiplier of one weak_dp round (see module
    docstring): per-client absolute noise ``stddev`` on updates clipped
    to ``norm_bound``, combined by the weighted mean with ``weights``."""
    if norm_bound <= 0 or stddev <= 0:
        raise ValueError(
            f"weak_dp accounting needs norm_bound > 0 and stddev > 0 "
            f"(got norm_bound={norm_bound}, stddev={stddev})")
    w = validate_weights(weights)
    return float(stddev * math.sqrt(float(np.sum(w * w)))
                 / (norm_bound * float(np.max(w))))


class RDPAccountant:
    """Additive RDP ledger over a fixed order grid.

    ``step(q, noise_multiplier, steps)`` adds the RDP of ``steps``
    subsampled-Gaussian rounds (heterogeneous rounds compose by calling
    it again with different parameters); ``epsilon()`` converts the
    running total to the tightest (epsilon, delta). Pure host numpy.
    """

    def __init__(self, delta: float = 1e-5, orders=DEFAULT_ORDERS):
        if not 0.0 < delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {delta}")
        self.delta = float(delta)
        self.orders = tuple(int(a) for a in orders)
        self._rdp = np.zeros(len(self.orders), np.float64)
        self.steps = 0

    def step(self, q: float, noise_multiplier: float,
             steps: int = 1) -> None:
        if steps < 0:
            raise ValueError(f"steps must be >= 0, got {steps}")
        if steps:
            self._rdp = self._rdp + steps * rdp_gaussian(
                q, noise_multiplier, self.orders)
            self.steps += int(steps)

    def epsilon(self) -> float:
        if self.steps == 0:
            return 0.0
        return rdp_to_epsilon(self._rdp, self.orders, self.delta)[0]

    def spent(self) -> dict:
        """JSON-able report for stat_info / the run-end audit."""
        return {"epsilon": self.epsilon(), "delta": self.delta,
                "steps": self.steps}
