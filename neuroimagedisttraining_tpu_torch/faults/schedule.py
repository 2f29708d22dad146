"""Seeded fault schedule. For now only DisPFL's activity draw: a pure
function of ``(seed, round)`` on a numpy generator of its own, so the same
seed gives the same draw in any process and in any order of queries."""

from __future__ import annotations

import numpy as np


def activity_mask(seed: int, round_idx: int, n: int,
                  active_prob: float) -> np.ndarray:
    """DisPFL's per-round Bernoulli(``active_prob``) draw for ``n``
    clients: one generator seeded ``seed * 100003 + round_idx``, one
    uniform per client."""
    rng = np.random.default_rng(seed * 100003 + round_idx)
    return rng.random(n) < active_prob
