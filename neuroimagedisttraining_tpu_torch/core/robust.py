"""Byzantine-robust aggregation defenses (the reference package's
``core/robust.py``).

The clip family (``norm_diff_clipping``, ``weak_dp``) transforms each
client's parameters before the weighted mean: ``w_t + diff / max(1,
||diff|| / norm_bound)``, ``diff = w_local - w_t``, one global norm over
every parameter leaf (BatchNorm statistics are never clipped), and weak
DP adds Gaussian noise ``N(0, stddev^2)`` on top of the clip.

The order-statistic family replaces the weighted mean:

- ``trimmed_mean`` / ``median``: coordinate-wise (Yin et al. 2018). Per
  coordinate the voting clients' values are sorted (stable: ties keep the
  client order), the ``byz_f`` smallest and largest dropped (median: the
  middle kept), the rest averaged with the clients' sample-count weights
  renormalized over the survivors (the median unweighted).
- ``krum`` / ``multi_krum`` (Blanchard et al. 2017): a client's score is
  the sum of its squared distances to its ``n - f - 2`` nearest other
  clients; the lowest score is selected (multi: the best ``n - f - 2``)
  and the selection's weighted mean returned.
- ``geometric_median``: ``geomed_iters`` Weiszfeld steps from the
  weighted mean.

A client's upload is a state dict (name -> tensor); a cohort is a list of
them, the reference's client axis. Zero-weight rows (non-finite uploads
swapped for the broadcast reference) do not vote. Every operation stays on
the tensors' device: no host sync.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

State = dict[str, torch.Tensor]

#: the noise streams of :func:`noise_draws`
NOISE_STREAMS = {"attack": 1, "weak_dp": 2, "dp": 3}


def noise_draws(seed: int, stream: str, round_idx: int, client: int,
                like: State) -> State:
    """Standard normal draws shaped like each leaf of ``like``, for the
    noise ``stream`` (``NOISE_STREAMS``: the Gaussian attack, the weak-DP
    defense, D-PSGD's DP) of client ``client`` (rank ``client + 1``) in
    round ``round_idx``: each leaf from a generator on ``like``'s device
    keyed by (seed, stream, round, rank, leaf). The engines and the
    cross-silo silos and server draw them alike."""
    out = {}
    for i, (k, v) in enumerate(like.items()):
        key = np.random.SeedSequence(
            [int(seed), NOISE_STREAMS[stream], int(round_idx) + 1,
             int(client) + 1, i]).generate_state(2, np.uint32)
        gen = torch.Generator(device=v.device).manual_seed(
            (int(key[0]) | int(key[1]) << 32) & (2 ** 63 - 1))
        out[k] = torch.randn(v.shape, generator=gen, device=v.device,
                             dtype=torch.float32)
    return out

#: clip-family defenses: per-client transforms BEFORE the weighted mean
CLIP_DEFENSES = ("none", "norm_diff_clipping", "weak_dp")
#: order-statistic defenses: replace the weighted mean outright
ROBUST_AGGREGATORS = ("trimmed_mean", "median", "krum", "multi_krum",
                      "geometric_median")
DEFENSES = CLIP_DEFENSES + ROBUST_AGGREGATORS


def validate_defense(name: str) -> str:
    """Fail at startup on an unknown defense name."""
    if name not in DEFENSES:
        raise ValueError(
            f"unknown defense {name!r}; one of {', '.join(DEFENSES)}")
    return name


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def tree_dot(a: State, b: State) -> torch.Tensor:
    """Sum over leaves of each leaf's float32 dot product."""
    return torch.stack([torch.dot(a[k].reshape(-1).float(),
                                  b[k].reshape(-1).float()) for k in a]).sum()


def weighted_mean(states: list[State], weights: torch.Tensor) -> State:
    """The weighted mean over clients (weights normalized first, then
    ``sum_c x_c * w_c`` per leaf): FedAvg's."""
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    out = {}
    for k in states[0]:
        x = torch.stack([st[k] for st in states]).float()
        out[k] = torch.sum(x * w.reshape((-1,) + (1,) * (x.dim() - 1)),
                           dim=0).to(states[0][k].dtype)
    return out


def norm_diff_clip(local: State, global_: State, norm_bound: float) -> State:
    """``w_t + diff / max(1, ||diff|| / norm_bound)``, ``diff = w_local -
    w_t``, the norm over every leaf of ``local``."""
    diff = {k: local[k] - global_[k] for k in local}
    norm = torch.sqrt(torch.clamp(tree_dot(diff, diff), min=0.0))
    scale = torch.clamp(norm / _f32(norm_bound, norm), min=1.0)
    inv = 1.0 / scale
    return {k: global_[k] + diff[k] * inv for k in local}


def add_weak_dp_noise(params: State, noise: State, stddev: float) -> State:
    """``params + noise * stddev``, ``noise`` standard normal draws (the
    caller's generator) shaped like each leaf."""
    return {k: (x + noise[k] * _f32(stddev, x)).to(x.dtype)
            for k, x in params.items()}


def defend_stacked(params: list[State], global_params: State, *,
                   defense: str, norm_bound: float, stddev: float,
                   noises: list[State] | None = None) -> list[State]:
    """The clip family over each client's parameters: ``norm_diff_clipping``
    clips every client's update norm to ``norm_bound``; ``weak_dp`` clips
    and adds per-client noise (``noises``: each client's standard normal
    draws). ``none`` and the order-statistic defenses pass the list
    through unchanged (they act at aggregation, ``robust_aggregate``)."""
    validate_defense(defense)
    if defense == "none" or defense in ROBUST_AGGREGATORS:
        return params
    clipped = [norm_diff_clip(p, global_params, norm_bound) for p in params]
    if defense == "weak_dp":
        if noises is None:
            raise ValueError("weak_dp needs per-client noise")
        clipped = [add_weak_dp_noise(p, n, stddev)
                   for p, n in zip(clipped, noises)]
    return clipped


# ---------------------------------------------------------------------------
# non-finite upload guard
# ---------------------------------------------------------------------------

def finite_per_client(states: list[State]) -> torch.Tensor:
    """[C] bool: client c is finite in every leaf."""
    return torch.stack([
        torch.stack([torch.isfinite(v).all() for v in st.values()]).all()
        for st in states])


def replace_nonfinite_clients(states: list[State], reference: State,
                              finite: torch.Tensor) -> list[State]:
    """Each non-finite client's row swapped for the broadcast ``reference``
    (a no-op update); callers also zero its weight."""
    return [{k: torch.where(finite[c], v, reference[k])
             for k, v in st.items()} for c, st in enumerate(states)]


# ---------------------------------------------------------------------------
# order-statistic aggregators
# ---------------------------------------------------------------------------

def _check_f(n: int, f: int, defense: str) -> int:
    f = int(f)
    if f < 0:
        raise ValueError(f"byz_f must be >= 0, got {f}")
    if defense in ("krum", "multi_krum"):
        # n >= f+3 is the mechanical floor (the score sums distances to
        # n-f-2 >= 1 nearest peers); Blanchard et al.'s resilience needs
        # n >= 2f+3 (effective_defense warns between the two)
        if n < f + 3:
            raise ValueError(
                f"{defense} needs n >= byz_f + 3 sampled clients "
                f"(n={n}, byz_f={f}): the score sums distances to the "
                "n-f-2 nearest peers (the provable Blanchard guarantee "
                "additionally needs n >= 2*byz_f + 3)")
    elif 2 * f >= n:
        raise ValueError(
            f"{defense} breakdown point exceeded: needs 2*byz_f < n "
            f"(n={n}, byz_f={f})")
    return f


def _stack(states: list[State], k: str) -> torch.Tensor:
    return torch.stack([st[k] for st in states]).float()


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (x.dim() - 1))


def trimmed_mean(states: list[State], weights: torch.Tensor, f: int
                 ) -> State:
    """Coordinate-wise f-trimmed weighted mean over the voting (nonzero
    weight) rows; the trim depth shrinks to ``(k - 1) // 2`` a side when
    the k voting rows are too few for ``f``, and an all-zero cohort votes
    uniformly."""
    C = len(states)
    _check_f(C, f, "trimmed_mean")
    w = weights.float()
    valid = w > 0
    any_valid = valid.any()
    valid = valid | ~any_valid
    wv = torch.where(valid, torch.where(any_valid, w, torch.ones_like(w)),
                     torch.zeros_like(w))
    k = valid.sum()
    lo = torch.clamp(torch.div(k - 1, 2, rounding_mode="floor"), max=int(f))
    hi = k - lo
    pos = torch.arange(C, device=w.device)
    keep = ((pos >= lo) & (pos < hi)).float()
    out = {}
    for name in states[0]:
        x = _stack(states, name)
        order = torch.argsort(torch.where(_bcast(valid, x), x,
                                          torch.full_like(x, float("inf"))),
                              dim=0, stable=True)
        xs = torch.take_along_dim(x, order, dim=0)
        ws = torch.take_along_dim(_bcast(wv, x).expand_as(x), order, dim=0)
        ws = ws * _bcast(keep, x)
        num = torch.sum(xs * ws, dim=0)
        den = torch.clamp(torch.sum(ws, dim=0), min=1e-12)
        out[name] = (num / den).to(states[0][name].dtype)
    return out


def coordinate_median(states: list[State],
                      weights: torch.Tensor | None = None) -> State:
    """Coordinate-wise median, unweighted among the voting rows (``weights``
    only gates who votes: zero-weight rows are left out; an all-zero
    cohort votes whole). An even count averages the two middle values."""
    C = len(states)
    dev = states[0][next(iter(states[0]))].device
    valid = (torch.ones(C, dtype=torch.bool, device=dev) if weights is None
             else weights.float() > 0)
    valid = valid | ~valid.any()
    k = valid.sum()
    lo = torch.div(k - 1, 2, rounding_mode="floor")
    hi = torch.div(k, 2, rounding_mode="floor")
    out = {}
    for name in states[0]:
        x = _stack(states, name)
        xs = torch.sort(torch.where(_bcast(valid, x), x,
                                    torch.full_like(x, float("inf"))),
                        dim=0).values
        flat = xs.reshape(C, -1)
        a = flat.index_select(0, lo.reshape(1))[0]
        b = flat.index_select(0, hi.reshape(1))[0]
        out[name] = (0.5 * (a + b)).reshape(x.shape[1:]).to(
            states[0][name].dtype)
    return out


def _stacked_matrix(states: list[State]) -> torch.Tensor:
    """[C, D] float32: every client's leaves flattened and concatenated."""
    return torch.stack([torch.cat([v.reshape(-1).float()
                                   for v in st.values()]) for st in states])


def krum_select(states: list[State], weights: torch.Tensor, f: int,
                m: int) -> torch.Tensor:
    """[m] client indices with the lowest Krum scores; zero-weight clients
    are pushed out of the selection by a 1e30 penalty."""
    V = _stacked_matrix(states)
    C = V.shape[0]
    sq = torch.sum(V * V, dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (V @ V.T), min=0.0)
    srt = torch.sort(d2, dim=1).values  # column 0 is the self-distance
    closest = max(1, C - int(f) - 2)
    scores = torch.sum(srt[:, 1:closest + 1], dim=1)
    scores = scores + torch.where(weights > 0, 0.0, 1e30).float()
    return torch.argsort(scores, stable=True)[:m]


def krum(states: list[State], weights: torch.Tensor, f: int,
         multi: bool = False) -> State:
    """(multi-)Krum: the weighted mean of the selection (uniform where
    every selected weight is 0)."""
    C = len(states)
    _check_f(C, f, "multi_krum" if multi else "krum")
    m = max(1, C - int(f) - 2) if multi else 1
    sel = krum_select(states, weights, f, m)
    chosen = {name: _stack(states, name).index_select(0, sel)
              for name in states[0]}
    wsel = weights.float().index_select(0, sel)
    wsel = torch.where(wsel.sum() > 0, wsel, torch.ones_like(wsel))
    w = wsel / torch.clamp(torch.sum(wsel), min=1e-12)
    return {name: torch.sum(x * _bcast(w, x), dim=0).to(states[0][name].dtype)
            for name, x in chosen.items()}


def geometric_median(states: list[State], weights: torch.Tensor,
                     iters: int = 8) -> State:
    """Weighted geometric median by ``iters`` Weiszfeld steps from the
    weighted mean; the reweighting ``1 / max(dist, 1e-8)`` keeps the
    iterates finite on a client point."""
    w = weights.float()
    w = torch.where(w.sum() > 0, w, torch.ones_like(w))
    z = weighted_mean(states, w)
    for _ in range(int(iters)):
        d2 = torch.stack([tree_dot(*(({k: u[k] - z[k] for k in u},) * 2))
                          for u in states])
        beta = w / torch.clamp(torch.sqrt(torch.clamp(d2, min=0.0)),
                               min=1e-8)
        z = weighted_mean(states, beta)
    return z


def effective_defense(defense: str, n: int, f: int,
                      warn: Callable | None = None) -> str:
    """The defense a cohort of ``n`` clients can run: an order-statistic
    defense whose breakdown requirement fails over ``n`` (crashes can shrink
    a round's cohort below what the startup check saw) falls back to
    ``"none"`` with a warning; Krum below 2f+3 warns and runs."""
    if defense not in ROBUST_AGGREGATORS:
        return defense
    try:
        _check_f(n, f, defense)
    except ValueError as e:
        if warn is not None:
            warn("defense %s infeasible over this round's %d-client "
                 "cohort (%s) - falling back to the plain weighted "
                 "mean for rounds at this cohort size", defense, n, e)
        return "none"
    if defense in ("krum", "multi_krum") and n < 2 * f + 3 \
            and warn is not None:
        warn("%s over a %d-client cohort with byz_f=%d is below the "
             "provable Blanchard bound n >= 2f+3: the selection runs, "
             "but %d COLLUDING attackers (mutual distance 0) can win "
             "it — treat the guarantee as empirical at this size",
             defense, n, f, f)
    return defense


def robust_aggregate(states: list[State], weights: torch.Tensor, *,
                     defense: str, byz_f: int, geomed_iters: int = 8
                     ) -> State:
    """One order-statistic aggregator over a cohort's uploads."""
    if defense == "trimmed_mean":
        return trimmed_mean(states, weights, byz_f)
    if defense == "median":
        _check_f(len(states), byz_f, "median")
        return coordinate_median(states, weights)
    if defense == "krum":
        return krum(states, weights, byz_f, multi=False)
    if defense == "multi_krum":
        return krum(states, weights, byz_f, multi=True)
    if defense == "geometric_median":
        return geometric_median(states, weights, iters=geomed_iters)
    validate_defense(defense)
    raise ValueError(
        f"defense {defense!r} is not an order-statistic aggregator; "
        f"have {ROBUST_AGGREGATORS}")


def aggregate_with_defense(states: list[State], reference: State,
                           weights: torch.Tensor, *, defense: str,
                           norm_bound: float = 5.0, stddev: float = 0.0,
                           noises: list[State] | None = None, byz_f: int = 1,
                           geomed_iters: int = 8,
                           mean_fn: Callable | None = None) -> State:
    """The defended aggregation: the clip family per client, then
    ``mean_fn`` (default :func:`weighted_mean`); the order-statistic
    family over the cohort whole."""
    validate_defense(defense)
    if defense in ROBUST_AGGREGATORS:
        return robust_aggregate(states, weights, defense=defense,
                                byz_f=byz_f, geomed_iters=geomed_iters)
    defended = defend_stacked(states, reference, defense=defense,
                              norm_bound=norm_bound, stddev=stddev,
                              noises=noises)
    return (mean_fn or weighted_mean)(defended, weights)
