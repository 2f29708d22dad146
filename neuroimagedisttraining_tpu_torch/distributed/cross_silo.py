"""Cross-silo federated orchestration over the control plane (the reference
package's ``distributed/cross_silo.py``).

A server and one process (or thread) per silo run the protocol {register ->
broadcast -> local train -> upload -> aggregate -> sync or finish} over a
transport (``comm.py``, ``broker.py``). Each ``FedAvgClientProc`` owns a
``train_fn(params, round_idx) -> (params, num_samples)``; the silos of
``distributed/run.py`` train the port's ``LocalTrainer`` on their own shard
on their own device (:func:`make_silo_train_fn`).

What rides the wire is the reference's: a model is the nested tree
``{"params": ..., "batch_stats": ...}`` of numpy leaves in flax's layout
(``weights.state_to_flax``), a codec upload the reference's frame, a secure
upload the reference's share tree or field-element frame. The server keeps
the model as such a tree and aggregates on its device (``device``) with the
port's own operations: ``utils/pytree.tree_weighted_mean`` (FedAvg, the
engines' aggregation) or ``core/robust.aggregate_with_defense``.

Randomness is the port's own: a silo's epoch permutations and dropout come
from its trainer's generator, seeded a round from ``(seed, rank, round)``
(:func:`silo_round_seed`); the weak-DP noise of a silo's upload is drawn
from one generator a (silo, leaf), keyed as the engines key theirs
(:func:`silo_noise`).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Mapping

import numpy as np

from neuroimagedisttraining_tpu_torch.codec import wire as codec
from neuroimagedisttraining_tpu_torch.distributed import message as M
from neuroimagedisttraining_tpu_torch.distributed.managers import (
    ClientManager, ServerManager,
)
from neuroimagedisttraining_tpu_torch.obs import flight as obs_flight
from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
from neuroimagedisttraining_tpu_torch.obs import names as obs_names
from neuroimagedisttraining_tpu_torch.obs import rules as obs_rules
from neuroimagedisttraining_tpu_torch.obs import trace as obs_trace

log = logging.getLogger("neuroimagedisttraining_tpu_torch.cross_silo")

# ---------------------------------------------------------------------------
# nested numpy trees (the wire's model trees)
# ---------------------------------------------------------------------------

def named_leaves(tree: Mapping, prefix: str = "") -> dict[str, Any]:
    """A nested tree's leaves keyed by their ``/``-joined paths, in sorted
    key order at every level (flax's leaf order)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(named_leaves(v, path))
        else:
            out[path] = v
    return out


def tree_map(fn: Callable, *trees: Mapping) -> dict:
    """``fn`` leaf by leaf over nested trees of one structure."""
    out = {}
    for k in sorted(trees[0]):
        vs = [t[k] for t in trees]
        out[k] = (tree_map(fn, *vs) if isinstance(vs[0], Mapping)
                  else fn(*vs))
    return out


def to_numpy_tree(tree: Mapping) -> dict:
    """Every leaf as a numpy array on the host (a tensor's values)."""
    def leaf(x):
        if codec._is_tensor(x):
            return x.detach().cpu().numpy()
        return np.asarray(x)
    return tree_map(leaf, tree)


def _named_tensors(tree: Mapping, device) -> dict[str, torch.Tensor]:
    """A tree's named leaves as tensors on ``device`` (copies)."""
    import torch

    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(device, copy=True)
            for k, v in named_leaves(tree).items()}


def _stack_named(trees: list, device) -> dict[str, torch.Tensor]:
    import torch

    named = [named_leaves(t) for t in trees]
    return {k: torch.as_tensor(np.stack([np.asarray(n[k]) for n in named]))
            .to(device) for k in named[0]}


def silo_device(device="cuda") -> torch.device:
    """The device a server or silo runs on: ``cuda`` unless the caller asks
    for the CPU (a CUDA device that does not exist raises), with its index
    resolved, so the threads of one process name one device alike."""
    import torch

    from neuroimagedisttraining_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _tree_of(named: Mapping[str, torch.Tensor]) -> dict:
    return codec.nest({k: v.detach().cpu().numpy() for k, v in named.items()})


def survivor_weighted_mean(trees: list, ns: list[float],
                           device="cuda") -> dict:
    """The sample-count-weighted mean over whichever silos reported, by
    ``utils/pytree.tree_weighted_mean`` (the engines' FedAvg aggregation)
    on ``device`` (:func:`silo_device`): a deadline-truncated round is the
    engine's round over the same survivors, bit for bit."""
    import torch

    from neuroimagedisttraining_tpu_torch.utils.pytree import (
        tree_weighted_mean,
    )

    device = silo_device(device)
    stacked = _stack_named(trees, device)
    out = tree_weighted_mean(stacked, torch.tensor(
        [float(n) for n in ns], dtype=torch.float32, device=device))
    return _tree_of(out)


def silo_noise(seed: int, round_idx: int, silo: int,
               like: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Silo ``silo``'s weak-DP draws in round ``round_idx``, shaped like
    ``like``: ``core/robust.noise_draws`` of client ``silo - 1``, as the
    engines draw a client's."""
    from neuroimagedisttraining_tpu_torch.core import robust

    return robust.noise_draws(seed, "weak_dp", round_idx, silo - 1, like)


def survivor_defended_mean(trees: list, ns: list[float], reference, *,
                           defense: str, byz_f: int = 1,
                           geomed_iters: int = 8, norm_bound: float = 5.0,
                           stddev: float = 0.0, noises: list | None = None,
                           device="cuda") -> dict:
    """The defended aggregation over whichever silos reported, by
    ``core/robust.aggregate_with_defense`` on ``device``
    (:func:`silo_device`; the clip family a
    silo, then the weighted mean; the order-statistic family in place of
    the mean). ``reference`` is the round's broadcast model; ``weak_dp``
    also needs ``noises``, one dict of standard normal draws a reporting
    silo (:func:`silo_noise`)."""
    import torch

    from neuroimagedisttraining_tpu_torch.core import robust

    if defense == "weak_dp" and noises is None:
        raise ValueError("weak_dp needs per-client noise")
    device = silo_device(device)
    states = [_named_tensors(t, device) for t in trees]
    out = robust.aggregate_with_defense(
        states, _named_tensors(reference, device),
        torch.tensor([float(n) for n in ns], dtype=torch.float32,
                     device=device),
        defense=defense, norm_bound=norm_bound, stddev=stddev,
        noises=noises, byz_f=byz_f, geomed_iters=geomed_iters)
    return _tree_of(out)


def tree_all_finite(tree) -> bool:
    """Every leaf of ``tree`` is free of NaN and Inf (host)."""
    return all(np.isfinite(np.asarray(x, np.float64)).all()
               for x in named_leaves(tree).values())


def update_outlier_flags(trees: list, reference, *,
                         norm_mult: float = 4.0,
                         cos_thresh: float = -0.5):
    """Per-silo anomaly flags over one round's decoded uploads: silo i is
    flagged when its update (against the round's broadcast ``reference``)
    has a norm above ``norm_mult`` x the cohort's median, or a cosine
    below ``cos_thresh`` against the mean update of the OTHER silos (a
    sign-flipped upload scores about -1). Host float64 over a handful of
    silos. Returns ``(flags, norms)``."""
    ref = named_leaves(reference)
    vecs = [np.concatenate([
        (np.asarray(a, np.float64) - np.asarray(ref[k], np.float64)).ravel()
        for k, a in named_leaves(t).items()]) for t in trees]
    V = np.stack(vecs)
    norms = np.linalg.norm(V, axis=1)
    med = float(np.median(norms))
    total = V.sum(axis=0)
    n = len(trees)
    flags = []
    for i in range(n):
        flag = med > 0 and norms[i] > norm_mult * med
        if not flag and n >= 3 and norms[i] > 0:
            others = (total - V[i]) / (n - 1)
            o_norm = np.linalg.norm(others)
            if o_norm > 0:
                cos = float(V[i] @ others) / (norms[i] * o_norm)
                flag = cos < cos_thresh
        flags.append(bool(flag))
    return flags, norms


# ---------------------------------------------------------------------------
# the silo's training closure and its codec threshold
# ---------------------------------------------------------------------------

#: one lock a device: the trainers of a process share the device's graph
#: stream (``core/graphs.py``), so silos trained as threads of one process
#: train one at a time
_TRAIN_LOCKS: dict[str, threading.Lock] = {}
_TRAIN_LOCKS_GUARD = threading.Lock()


def train_lock(device) -> threading.Lock:
    import torch

    key = str(torch.device(device))
    with _TRAIN_LOCKS_GUARD:
        return _TRAIN_LOCKS.setdefault(key, threading.Lock())


def silo_round_seed(seed: int, rank: int, round_idx: int) -> int:
    """The seed of silo ``rank``'s trainer generator in round
    ``round_idx`` (its epoch permutations and dropout)."""
    key = np.random.SeedSequence([int(seed) + 17 + int(rank),
                                  int(round_idx)]).generate_state(
        2, np.uint32)
    return (int(key[0]) | int(key[1]) << 32) & (2 ** 63 - 1)


def make_silo_train_fn(trainer, X: torch.Tensor, y: torch.Tensor, n: int, *,
                       rank: int, seed: int, lr: float, lr_decay: float,
                       epochs: int, batch_size: int,
                       shapes: Mapping[str, tuple], mask=None,
                       perms_for: Callable | None = None,
                       announce: bool = True) -> Callable:
    """The silo's ``train_fn(tree, round_idx) -> (tree, n)``: the port's
    ``LocalTrainer.local_train`` over the silo's resident shard ``(X, y)``
    (``n`` rows) on the trainer's device, from the synced model, at the
    round-decayed lr ``lr * lr_decay ** round`` (float32), with the
    post-step re-mask ``mask`` (a state of the model's parameters) where
    given. The trainer's generator is seeded for the round by
    :func:`silo_round_seed`; ``perms_for(round_idx)`` gives the epoch
    permutations instead (tests feed the reference's). The steps run as
    the trainer's CUDA graph replays on a card. Trees in and out are the
    wire's (flax layout, numpy)."""
    import torch

    from neuroimagedisttraining_tpu_torch.weights import (
        state_from_flax, state_to_flax,
    )

    dev = trainer.device
    p_shapes = {k: s for k, s in shapes.items()
                if not k.endswith(("running_mean", "running_var"))}
    b_shapes = {k: s for k, s in shapes.items() if k not in p_shapes}

    def train_fn(tree, round_idx: int):
        params = state_from_flax(tree["params"], p_shapes, device=dev)
        bstats = state_from_flax(tree["batch_stats"], b_shapes, device=dev)
        trainer.generator.manual_seed(silo_round_seed(seed, rank, round_idx))
        lr_r = torch.tensor(np.float32(lr) * np.float32(lr_decay)
                            ** np.float32(round_idx), dtype=torch.float32,
                            device=dev)
        perms = perms_for(round_idx) if perms_for is not None else None
        p, b, loss = trainer.local_train(
            params, bstats, X, y, n, lr_r, epochs, batch_size,
            max_samples=int(X.shape[0]), mask=mask, perms=perms)
        out = {"params": state_to_flax(p, False),
               "batch_stats": state_to_flax(b, True)}
        if announce:
            print(f"[silo {rank}] round {round_idx}: "
                  f"loss={float(loss):.4f} (n={n})", flush=True)
        return out, float(n)

    return train_fn


class CodecThreshold:
    """The wire codec's top-k threshold on a silo's device: the k-th
    largest ``|residual|`` by ``ops/topk.kth_largest`` (the ``kth_select``
    kernel on a card, its plain version on the CPU; a card that cannot
    build or launch it raises). The select's threshold keeps at least k
    entries; where it keeps ``e`` more (its last bracket holds scores
    below the exact value), the exact value is the ``e``-th smallest of
    the kept scores, taken on the host, so a frame is byte for byte the
    ``np.partition`` encode's. ``refined`` counts the thresholds so taken,
    ``extra_kept`` the entries beyond k the select's kept."""

    def __init__(self, device):
        import torch

        self.device = torch.device(device)
        self.calls = 0
        self.refined = 0
        self.extra_kept = 0

    def __call__(self, absflat: np.ndarray, k: int) -> np.float32:
        import torch

        from neuroimagedisttraining_tpu_torch.ops.topk import kth_largest

        k = min(max(int(k), 1), absflat.size)
        x = torch.from_numpy(np.ascontiguousarray(absflat, np.float32))
        thr = np.float32(kth_largest(x.to(self.device), k).item())
        self.calls += 1
        if np.isfinite(thr):
            kept = absflat[absflat >= thr]
            extra = kept.size - k
            if extra > 0:
                thr = np.partition(kept, extra)[extra]
                self.refined += 1
                self.extra_kept += int(extra)
        return thr


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

class FedAvgServer(ServerManager):
    """Rank 0: aggregates the silos' uploads sample-weighted each round.

    Fault tolerance (opt-in; the defaults are the strict protocol that
    waits for every silo):

    - ``round_deadline`` > 0 arms a timer a round. When it fires with at
      least ``quorum`` uploads the server aggregates the survivors with
      sample-count re-weighting and marks the missing silos suspect; below
      ``quorum`` it re-arms and keeps waiting (the quorum is a floor).
    - uploads carry their round: a stale upload (a straggler past the
      deadline) and a duplicate frame never count twice.
    - ``heartbeat_timeout`` > 0 starts a monitor that marks a silo suspect
      once its heartbeat is stale (within ~``timeout * 5 / 4``).
    - a suspect silo that registers again gets the current round's model
      at once (late rejoin); an upload or a beat clears suspicion.

    Wire codec: an upload may be a codec frame (``codec/wire.py``), decoded
    against ``self.params`` (the round's broadcast, the sender's delta
    reference) before aggregation; ``wire_masks`` is the mask shared-mask
    frames need. The sync stays dense.

    Byzantine robustness: a decoded upload with NaN/Inf is rejected before
    aggregation (``byz_stats``); ``defense`` chooses the aggregation rule
    (``core/robust.py``, validated here); ``quarantine_rounds`` > 0 scores
    each round's updates (``update_outlier_flags``), strikes flagged silos
    (a clean round forgives one) and quarantines a silo at
    ``outlier_threshold`` strikes for ``quarantine_rounds`` rounds (at
    most ``byz_f`` at once); its first sync after the window carries
    ``ARG_EF_RESET``. ``weak_dp`` charges each reporting silo's RDP ledger
    (``dp_report``).

    ``device``: where the aggregation runs, ``cuda`` unless the caller
    asks for the CPU (:func:`silo_device`). ``aggregate_seconds`` keeps
    each aggregation's host seconds (decoded uploads to the new model on
    the host)."""

    def __init__(self, init_params, comm_round: int, num_clients: int,
                 world_size: int | None = None, round_deadline: float = 0.0,
                 quorum: int = 0, heartbeat_timeout: float = 0.0,
                 wire_masks=None, defense: str = "none", byz_f: int = 1,
                 geomed_iters: int = 8, norm_bound: float = 5.0,
                 stddev: float = 0.05, defense_seed: int = 0,
                 quarantine_rounds: int = 0, outlier_threshold: int = 2,
                 dp_delta: float = 1e-5, device="cuda", **kw):
        from neuroimagedisttraining_tpu_torch.core import robust

        # before the transport opens: a missing card fails here
        device = silo_device(device)
        super().__init__(rank=0, world_size=world_size or num_clients + 1,
                         **kw)
        self.device = device
        # the defense's configuration fails here, at startup
        self.defense = robust.validate_defense(defense)
        self.byz_f = int(byz_f)
        self.geomed_iters = int(geomed_iters)
        self.norm_bound = float(norm_bound)
        self.stddev = float(stddev)
        #: root of the weak-DP noise: (defense_seed, round, silo, leaf)
        self.defense_seed = int(defense_seed)
        if self.defense in robust.ROBUST_AGGREGATORS:
            robust._check_f(num_clients, self.byz_f, self.defense)
        self.quarantine_rounds = int(quarantine_rounds)
        self.outlier_threshold = int(outlier_threshold)
        self._strikes: dict[int, int] = {}
        #: silo -> the first round after its quarantine window
        self._quarantine_until: dict[int, int] = {}
        #: silos owed an ARG_EF_RESET on their next sync after the window
        self._ef_reset_pending: set[int] = set()
        self.byz_stats = {"nonfinite_rejected": 0, "outlier_flags": 0,
                          "quarantines": []}
        #: weak_dp RDP ledger (privacy/accountant.py) a silo
        self.dp_delta = float(dp_delta)
        self._dp_rdp: dict[int, np.ndarray] = {}
        self._dp_round_info: dict | None = None
        self.params = to_numpy_tree(init_params)
        self.wire_masks = (to_numpy_tree(wire_masks)
                           if wire_masks is not None else None)
        self.comm_round = comm_round
        self.num_clients = num_clients
        self.round_deadline = float(round_deadline)
        self.quorum = int(quorum) if quorum > 0 else num_clients
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.round_idx = 0
        self._registered: set[int] = set()
        self._updates: dict[int, tuple] = {}
        #: silos whose upload this round was rejected (non-finite): they
        #: reported, so the round waits for them no longer
        self._rejected_round: set[int] = set()
        self.history: list[dict] = []
        self.aggregate_seconds: list[float] = []
        self._done = threading.Event()
        #: guards the round state: handlers run on the dispatch thread,
        #: the deadline timer and heartbeat monitor on their own
        self._rlock = threading.Lock()
        self._started = False
        self._suspect: set[int] = set()
        self._last_beat: dict[int, float] = {}
        self._timer: threading.Timer | None = None
        #: bumped at every arm: a timer callback that waited on the lock
        #: while its window passed becomes a no-op
        self._deadline_gen = 0
        # metrics published from the accept / aggregate handlers (host
        # code under _rlock); the flight ring gets every decision
        self._obs_uploads = obs_metrics.counter(
            obs_names.SYNC_UPLOADS,
            "sync-server upload admission verdicts",
            labelnames=("outcome",))
        self._obs_round_wall = obs_metrics.histogram(
            obs_names.SYNC_ROUND_WALL,
            "wall time from a round's sync broadcast to its completion",
            buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                     120.0, 300.0))
        self._obs_quorum_wait = obs_metrics.histogram(
            obs_names.SYNC_QUORUM_WAIT,
            "wall time from a round's FIRST accepted upload to its "
            "aggregation (how long the earliest silo waited on the "
            "barrier)",
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                     60.0))
        self._obs_round_gauge = obs_metrics.gauge(
            obs_names.SERVER_ROUND, "current server round/version index")
        self._obs_suspects = obs_metrics.gauge(
            obs_names.SERVER_SUSPECTS, "clients currently marked suspect")
        self._obs_strikes = obs_metrics.counter(
            obs_names.BYZ_STRIKES, "value-anomaly strikes issued")
        self._obs_quarantines = obs_metrics.counter(
            obs_names.BYZ_QUARANTINES, "silo quarantines entered")
        self._round_t0: float | None = None
        self._first_upload_t: float | None = None

    @property
    def fault_tolerant(self) -> bool:
        return self.round_deadline > 0 or self.heartbeat_timeout > 0

    def suspect_clients(self) -> set[int]:
        with self._rlock:
            return set(self._suspect)

    # ---- Byzantine detection and quarantine ----

    def _quarantined_now(self) -> set[int]:
        """Under ``_rlock``: silos inside a quarantine window."""
        return {c for c, until in self._quarantine_until.items()
                if self.round_idx < until}

    def quarantined_clients(self) -> set[int]:
        with self._rlock:
            return self._quarantined_now()

    def _strike(self, c: int, why: str) -> None:
        """Under ``_rlock``: one strike against silo ``c``; at
        ``outlier_threshold`` strikes it is quarantined, unless ``byz_f``
        silos already are."""
        self._strikes[c] = self._strikes.get(c, 0) + 1
        self.byz_stats["outlier_flags"] += 1
        self._obs_strikes.inc()
        obs_flight.record("strike", client=c, count=self._strikes[c],
                          threshold=self.outlier_threshold, why=why,
                          round=self.round_idx)
        log.warning("server: value-anomaly strike %d/%d against silo %d "
                    "(%s)", self._strikes[c], self.outlier_threshold, c,
                    why)
        if self._strikes[c] < self.outlier_threshold:
            return
        if len(self._quarantined_now()) >= max(1, self.byz_f):
            log.warning("server: silo %d hit the strike threshold but "
                        "the quarantine budget (byz_f=%d) is spent",
                        c, self.byz_f)
            return
        until = self.round_idx + 1 + self.quarantine_rounds
        self._quarantine_until[c] = until
        self._strikes[c] = 0
        self._ef_reset_pending.add(c)
        self._obs_quarantines.inc()
        obs_flight.record("quarantine", client=c,
                          from_round=self.round_idx + 1,
                          until_round=until)
        self.byz_stats["quarantines"].append(
            {"client": c, "from_round": self.round_idx + 1,
             "until_round": until})
        log.warning("server: QUARANTINED silo %d for rounds [%d, %d) — "
                    "its uploads are excluded from aggregation; its "
                    "first post-window sync will carry ef_reset", c,
                    self.round_idx + 1, until)

    # ---- weak_dp accounting ----

    def _note_weak_dp(self, senders: list[int],
                      ws: list[float]) -> dict | None:
        """Under ``_rlock``: charge one weak_dp round (a full-participation
        Gaussian at ``weak_dp_noise_multiplier`` over the round's actual
        weights) to every silo whose upload entered it. Returns the round's
        record, or None where the geometry gives no accountable noise or
        the weights are degenerate (warned, never raised on a dispatch or
        timer thread)."""
        from neuroimagedisttraining_tpu_torch.privacy import accountant as acct

        if self.stddev <= 0 or self.norm_bound <= 0:
            if not getattr(self, "_warned_dp_disabled", False):
                self._warned_dp_disabled = True
                log.warning(
                    "weak_dp with stddev=%s/norm_bound=%s adds no "
                    "accountable noise — epsilon is infinite; the RDP "
                    "ledger records nothing", self.stddev,
                    self.norm_bound)
            return None
        try:
            z = acct.weak_dp_noise_multiplier(self.stddev,
                                              self.norm_bound, ws)
        except ValueError as e:
            log.warning("weak_dp ledger: skipping round %d charge "
                        "(%s)", self.round_idx, e)
            return None
        step = acct.rdp_gaussian(1.0, z)
        eps = {}
        eps_gauge = obs_metrics.gauge(
            obs_names.DP_EPSILON_SILO,
            "running weak_dp epsilon per silo (server RDP ledger, "
            "privacy/accountant.py)", labelnames=("silo",))
        burn_gauge = obs_metrics.gauge(
            obs_names.DP_EPSILON_PER_ROUND,
            "epsilon spent by the last accounted round (the budget "
            "burn rate --dp_epsilon_budget is judged against)",
            labelnames=("source",))
        for c in senders:
            prev = self._dp_rdp.get(c)
            prev_eps = (acct.rdp_to_epsilon(prev,
                                            delta=self.dp_delta)[0]
                        if prev is not None else 0.0)
            self._dp_rdp[c] = self._dp_rdp.get(c, 0.0) + step
            eps[c] = acct.rdp_to_epsilon(self._dp_rdp[c],
                                         delta=self.dp_delta)[0]
            eps_gauge.labels(silo=c).set(float(eps[c]))
            burn_gauge.labels(source=f"silo{c}").set(
                float(eps[c] - prev_eps))
        return {"norm_bound": self.norm_bound, "stddev": self.stddev,
                "noise_multiplier": round(z, 6), "delta": self.dp_delta,
                "epsilon_per_silo": {c: round(e, 4)
                                     for c, e in eps.items()}}

    def dp_report(self) -> dict | None:
        """The run's (epsilon, delta) a silo from the weak_dp ledger, or
        None when no round was charged."""
        from neuroimagedisttraining_tpu_torch.privacy import accountant as acct

        with self._rlock:
            if not self._dp_rdp:
                return None
            return {"defense": "weak_dp", "delta": self.dp_delta,
                    "norm_bound": self.norm_bound, "stddev": self.stddev,
                    "epsilon_per_silo": {
                        c: round(acct.rdp_to_epsilon(
                            rdp, delta=self.dp_delta)[0], 4)
                        for c, rdp in sorted(self._dp_rdp.items())}}

    def _score_survivors(self, senders: list[int], trees: list) -> None:
        """Under ``_rlock``: outlier scoring of the round's accepted
        uploads into strikes (a clean round forgives one)."""
        if self.quarantine_rounds <= 0 or len(senders) < 3:
            return
        flags, norms = update_outlier_flags(trees, self.params)
        for c, flag, nrm in zip(senders, flags, norms):
            if flag:
                self._strike(c, f"update-delta outlier, |u|={nrm:.3g} "
                                f"round {self.round_idx}")
            elif self._strikes.get(c, 0) > 0:
                self._strikes[c] -= 1

    def run(self) -> None:
        if self.heartbeat_timeout > 0:
            threading.Thread(target=self._monitor_loop, daemon=True).start()
        super().run()

    # ---- handlers ----

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            M.MSG_TYPE_C2S_REGISTER, self._on_register)
        self.register_message_receive_handler(
            M.MSG_TYPE_C2S_SEND_MODEL, self._on_model)
        self.register_message_receive_handler(
            M.MSG_TYPE_C2S_HEARTBEAT, self._on_heartbeat)

    def _on_register(self, msg: M.Message) -> None:
        with self._rlock:
            c = msg.sender_id
            self._registered.add(c)
            self._suspect.discard(c)
            self._last_beat[c] = time.monotonic()
            if not self._started:
                if len(self._registered) == self.num_clients:
                    self._started = True
                    self._broadcast_sync(M.MSG_TYPE_S2C_INIT_CONFIG)
            else:
                # late rejoin: the current round's model at once
                obs_flight.record("rejoin", client=c,
                                  round=self.round_idx)
                log.info("server: client %d re-registered; shipping "
                         "round %d state", c, self.round_idx)
                self._send_sync_to(M.MSG_TYPE_S2C_SYNC_MODEL, c)

    def _on_heartbeat(self, msg: M.Message) -> None:
        with self._rlock:
            self._last_beat[msg.sender_id] = time.monotonic()
            self._suspect.discard(msg.sender_id)

    def _accept_update(self, msg: M.Message) -> bool:
        """Under ``_rlock``: True iff the upload is of the current round,
        the sender's first, and not from a quarantined silo."""
        r = msg.get(M.ARG_ROUND_IDX)
        if r is not None and int(r) != self.round_idx:
            self._obs_uploads.inc(outcome="stale")
            obs_flight.record("drop_stale", client=msg.sender_id,
                              tagged_round=int(r), round=self.round_idx)
            log.warning("server: dropping stale upload from %d "
                        "(round %s, current %d)", msg.sender_id, r,
                        self.round_idx)
            return False
        if msg.sender_id in self._updates:
            self._obs_uploads.inc(outcome="duplicate")
            obs_flight.record("drop_duplicate", client=msg.sender_id,
                              round=self.round_idx)
            log.warning("server: dropping duplicate upload from %d "
                        "(round %d)", msg.sender_id, self.round_idx)
            return False
        if msg.sender_id in self._quarantined_now():
            self._obs_uploads.inc(outcome="quarantined")
            obs_flight.record("drop_quarantined", client=msg.sender_id,
                              round=self.round_idx)
            log.warning("server: dropping upload from QUARANTINED silo "
                        "%d (round %d; window ends at round %d)",
                        msg.sender_id, self.round_idx,
                        self._quarantine_until[msg.sender_id])
            return False
        return True

    def _decode(self, payload, reference=None) -> dict:
        """An upload as a tree: a dense tree as it is, a codec frame
        decoded against ``reference``, by default the round's broadcast
        (``decode_update`` refuses a secure-quant frame)."""
        like = named_leaves(self.params)
        masks = (named_leaves(self.wire_masks)
                 if self.wire_masks is not None else None)
        out = codec.decode_update(
            payload, like=like, masks=masks,
            reference=like if reference is None else named_leaves(reference))
        return payload if out is payload else codec.nest(out)

    def _on_model(self, msg: M.Message) -> None:
        with self._rlock:
            if self._done.is_set() or not self._accept_update(msg):
                return
            # self.params is still the round's broadcast here: the
            # sender's delta reference
            try:
                decoded = self._decode(msg.get(M.ARG_MODEL_PARAMS))
            except Exception as e:  # noqa: BLE001 — an undecodable frame
                # (version skew, a mask mismatch, bit rot) is a dropped
                # upload, never a dead dispatch thread
                self._obs_uploads.inc(outcome="undecodable")
                obs_flight.record("drop_undecodable",
                                  client=msg.sender_id,
                                  round=self.round_idx, error=str(e))
                log.warning("server: dropping undecodable upload from %d "
                            "(round %d): %s", msg.sender_id,
                            self.round_idx, e)
                return
            # the non-finite gate, before any defense: one NaN frame in
            # the mean poisons every silo
            if not tree_all_finite(decoded):
                self.byz_stats["nonfinite_rejected"] += 1
                self._obs_uploads.inc(outcome="nonfinite")
                obs_flight.record("reject_nonfinite",
                                  client=msg.sender_id,
                                  round=self.round_idx)
                log.warning("server: REJECTING non-finite (NaN/Inf) "
                            "upload from silo %d (round %d; %d rejected "
                            "so far)", msg.sender_id, self.round_idx,
                            self.byz_stats["nonfinite_rejected"])
                if self.quarantine_rounds > 0:
                    self._strike(msg.sender_id, "non-finite upload")
                # the silo has reported: the round waits for it no longer
                self._rejected_round.add(msg.sender_id)
                self._maybe_complete()
                return
            if not self._updates:
                self._first_upload_t = time.monotonic()
            self._updates[msg.sender_id] = (
                decoded, float(msg.get(M.ARG_NUM_SAMPLES)))
            self._obs_uploads.inc(outcome="accepted")
            self._last_beat[msg.sender_id] = time.monotonic()
            self._suspect.discard(msg.sender_id)
            self._maybe_complete()

    def _maybe_complete(self) -> None:
        """Under ``_rlock``: aggregate once every silo that is neither
        suspect, quarantined nor rejected this round has reported (and the
        quorum floor holds)."""
        expected = (set(range(1, self.num_clients + 1)) - self._suspect
                    - self._quarantined_now() - self._rejected_round)
        have = set(self._updates)
        if not have and not expected and self._rejected_round:
            # every live silo reported and every upload bounced at the
            # non-finite gate: the round closes with the model unchanged
            log.warning("server: round %d has ZERO accepted uploads "
                        "(%d rejected as non-finite) - rebroadcasting "
                        "the unchanged global model", self.round_idx,
                        len(self._rejected_round))
            if self._timer is not None:
                self._timer.cancel()
            self._rejected_round.clear()
            self._complete_round(0, survivors=[])
            return
        if not have or not expected <= have or len(have) < min(
                self.quorum, self._effective_cohort()):
            return
        self._aggregate_and_advance()

    def _effective_cohort(self) -> int:
        """Under ``_rlock``: the cohort the quorum floor applies to (a
        quarantined or rejected silo cannot report this round)."""
        return max(1, self.num_clients - len(self._quarantined_now()
                                             | self._rejected_round))

    def _aggregate_and_advance(self) -> None:
        """Under ``_rlock``: the (defended) aggregation over whoever
        reported. Outlier scoring runs first, so a silo quarantined this
        round is left out of this very aggregation."""
        from neuroimagedisttraining_tpu_torch.core import robust

        if self._timer is not None:
            self._timer.cancel()
        t0 = time.perf_counter()
        senders = sorted(self._updates)
        trees = [self._updates[s][0] for s in senders]
        self._score_survivors(senders, trees)
        q = self._quarantined_now()
        if q & set(senders):
            senders = [s for s in senders if s not in q]
            trees = [self._updates[s][0] for s in senders]
        ws = [self._updates[s][1] for s in senders]
        # a deadline can shrink the survivors below what the defense
        # needs: the engines' feasibility rule decides
        defense = robust.effective_defense(
            self.defense, len(senders), self.byz_f, warn=log.warning)
        if defense == "none":
            self.params = survivor_weighted_mean(trees, ws, self.device)
        else:
            noises = None
            if defense == "weak_dp":
                like = _named_tensors(self.params, self.device)
                noises = [silo_noise(self.defense_seed, self.round_idx, s,
                                     like) for s in senders]
                self._dp_round_info = self._note_weak_dp(senders, ws)
            self.params = survivor_defended_mean(
                trees, ws, self.params, defense=defense,
                byz_f=self.byz_f, geomed_iters=self.geomed_iters,
                norm_bound=self.norm_bound, stddev=self.stddev,
                noises=noises, device=self.device)
        self.aggregate_seconds.append(time.perf_counter() - t0)
        self._updates.clear()
        self._rejected_round.clear()
        self._complete_round(len(senders), survivors=senders)

    # ---- deadline / heartbeat machinery ----

    def _arm_deadline(self) -> None:
        if self.round_deadline <= 0 or self._done.is_set():
            return
        if self._timer is not None:
            self._timer.cancel()
        self._deadline_gen += 1
        self._timer = threading.Timer(
            self.round_deadline, self._on_deadline,
            args=(self.round_idx, self._deadline_gen))
        self._timer.daemon = True
        self._timer.start()

    def _deadline_stale(self, round_for: int, gen: int) -> bool:
        """Under ``_rlock``: the callback's window was superseded while it
        waited for the lock."""
        return (self._done.is_set() or self.round_idx != round_for
                or gen != self._deadline_gen)

    def _mark_missing_suspect(self, have: set[int]) -> None:
        """Under ``_rlock``: silos that missed the deadline become suspect,
        unless their heartbeat is fresh (a straggler) or they are
        quarantined."""
        for c in (set(range(1, self.num_clients + 1)) - have
                  - self._quarantined_now()):
            if self._beat_stale(c):
                log.warning("server: marking client %d suspect "
                            "(missed round %d deadline)", c, self.round_idx)
                self._suspect.add(c)
                obs_flight.record("suspect", client=c,
                                  round=self.round_idx,
                                  why="missed deadline")
        self._obs_suspects.set(len(self._suspect))

    def _beat_stale(self, c: int) -> bool:
        if self.heartbeat_timeout <= 0:
            return True  # no liveness signal: missing is dead
        last = self._last_beat.get(c)
        return last is None or (time.monotonic() - last
                                > self.heartbeat_timeout)

    def _on_deadline(self, round_for: int, gen: int) -> None:
        with self._rlock:
            if self._deadline_stale(round_for, gen):
                return
            obs_flight.record("deadline", round=round_for,
                              have=len(self._updates),
                              quorum=min(self.quorum, self.num_clients))
            if self._updates and len(self._updates) >= min(
                    self.quorum, self.num_clients):
                self._mark_missing_suspect(set(self._updates))
                log.warning("server: round %d deadline - aggregating %d/%d "
                            "survivors", round_for, len(self._updates),
                            self.num_clients)
                self._aggregate_and_advance()
            else:
                self._arm_deadline()  # below quorum: keep waiting

    def _monitor_loop(self) -> None:
        poll = max(0.05, self.heartbeat_timeout / 4)
        while not self._done.wait(poll):
            now = time.monotonic()
            with self._rlock:
                if self._done.is_set():
                    return
                for c, last in list(self._last_beat.items()):
                    if (now - last > self.heartbeat_timeout
                            and c not in self._suspect):
                        log.warning("server: heartbeat from client %d "
                                    "stale (%.2fs) - marking suspect",
                                    c, now - last)
                        self._suspect.add(c)
                        obs_flight.record(
                            "suspect", client=c, round=self.round_idx,
                            why=f"heartbeat stale {now - last:.2f}s")
                        self._obs_suspects.set(len(self._suspect))
                if self._started:
                    # a new suspect may have been the last missing upload
                    self._maybe_complete()

    def _complete_round(self, n_clients: int,
                        survivors: list[int] | None = None) -> None:
        """The end of a round: history, advance, then finish or sync."""
        entry = {"round": self.round_idx, "clients": n_clients}
        now = time.monotonic()
        if self._round_t0 is not None:
            self._obs_round_wall.observe(now - self._round_t0)
        if self._first_upload_t is not None:
            self._obs_quorum_wait.observe(now - self._first_upload_t)
        self._first_upload_t = None
        obs_flight.record("round_complete", round=self.round_idx,
                          clients=n_clients,
                          survivors=list(survivors or []))
        if survivors is not None:
            entry["survivors"] = list(survivors)
        if self._dp_round_info is not None:
            entry["weak_dp"] = self._dp_round_info
            self._dp_round_info = None
        if self._suspect:
            entry["suspects"] = sorted(self._suspect)
        q = self._quarantined_now()
        if q:
            entry["quarantined"] = sorted(q)
        self.history.append(entry)
        self.round_idx += 1
        self._obs_round_gauge.set(self.round_idx)
        self._obs_suspects.set(len(self._suspect))
        # one rule evaluation a completed round (obs/rules.py)
        obs_rules.observe_boundary(self.round_idx)
        if self.round_idx >= self.comm_round:
            if self._timer is not None:
                self._timer.cancel()
            self._broadcast_finish()
            self._done.set()
            self.finish()
        else:
            self._broadcast_sync(M.MSG_TYPE_S2C_SYNC_MODEL)

    # ---- sends ----

    def _send_tolerant(self, msg: M.Message) -> None:
        """Fault-tolerant mode: a short retry budget, and an unreachable
        silo becomes suspect instead of killing the dispatch or timer
        thread. The strict mode raises. These sends run under
        ``_rlock``."""
        if not self.fault_tolerant:
            self.send_message(msg)
            return
        try:
            try:
                self.com_manager.send_message(msg, retries=3,
                                              retry_delay=0.05)
            except TypeError:  # transport without retry knobs (broker)
                self.com_manager.send_message(msg)
        except (ConnectionError, OSError) as e:
            log.warning("server: client %d unreachable (%s) - marking "
                        "suspect", msg.receiver_id, e)
            self._suspect.add(msg.receiver_id)

    def _send_sync_to(self, msg_type: str, c: int) -> None:
        msg = M.Message(msg_type, 0, c)
        msg.add(M.ARG_MODEL_PARAMS, self.params)
        msg.add(M.ARG_ROUND_IDX, self.round_idx)
        msg.add(M.ARG_CLIENT_INDEX, c - 1)
        if (c in self._ef_reset_pending
                and c not in self._quarantined_now()):
            # the silo's error feedback built up against frames this
            # server dropped: it matches nothing aggregated
            msg.add(M.ARG_EF_RESET, True)
            self._ef_reset_pending.discard(c)
            obs_flight.record("ef_reset", client=c, round=self.round_idx)
            log.info("server: silo %d quarantine window over - sync "
                     "carries ef_reset", c)
        self._send_tolerant(msg)

    def _broadcast_sync(self, msg_type: str) -> None:
        for c in range(1, self.num_clients + 1):
            self._send_sync_to(msg_type, c)
        self._round_t0 = time.monotonic()
        self._arm_deadline()

    def _broadcast_finish(self) -> None:
        for c in range(1, self.num_clients + 1):
            self._send_tolerant(M.Message(M.MSG_TYPE_S2C_FINISH, 0, c))


class SecureFedAvgServer(FedAvgServer):
    """The secure-aggregation server: silos upload additive share slots of
    their weight-scaled quantized update, never plaintext. A round has two
    phases: silos report their sample counts (A); the server answers each
    with its normalized weight ``w_c = n_c / sum n``, and silos share
    ``quantize(w_c * params)`` (B). Each share set folds into slot
    accumulators (mod p) and the slots combine once every weighted silo
    folded, or once the deadline and quorum truncate the cohort: a dropped
    silo's shares never folded (atomic discard) and the survivors' sum is
    re-weighted by ``1 / sum of their weights``.

    ``n_aggregators == K > 0``: silos send slot j to aggregator j
    (``SlotAggregatorProc``) and this server sees only the K cross-silo
    totals. ``quant_spec`` (``privacy/secure_quant.py``): phase B uploads
    are field-element frames folded by a ``SlotAccumulator``; the clip
    family then runs on each silo before it shares, and this server keeps
    the weak-DP ledger."""

    def __init__(self, init_params, comm_round: int, num_clients: int,
                 frac_bits: int = 16, n_aggregators: int = 0,
                 record_trace: bool = False, quant_spec=None, **kw):
        from neuroimagedisttraining_tpu_torch.core import robust

        defense = kw.get("defense", "none")
        if quant_spec is None and (defense != "none"
                                   or kw.get("quarantine_rounds", 0)):
            raise ValueError(
                "SecureFedAvgServer supports neither --defense nor "
                "quarantine in dense mode: additive-share aggregation "
                "never reveals per-silo updates to defend over. The "
                "clip-family defenses compose with --secure_quant "
                "(enforced CLIENT-side, pre-share); see ARCHITECTURE.md "
                "'Privacy plane'")
        if quant_spec is not None and (
                defense in robust.ROBUST_AGGREGATORS
                or kw.get("quarantine_rounds", 0)):
            raise ValueError(
                "secure_quant supports neither order-statistic defenses "
                "nor quarantine: the server still only ever sees masked "
                "field elements — there are no per-silo updates to "
                "select over or score. Clip-family defenses "
                "(norm_diff_clipping, weak_dp) run client-side, "
                "pre-share; see ARCHITECTURE.md 'Privacy plane'")
        if kw.get("wire_masks") is not None:
            raise ValueError(
                "SecureFedAvgServer is incompatible with the wire codec "
                "(shares are uniform field elements; encoding them would "
                "break the share algebra or leak mask support — use "
                "--secure_quant for the compressed secure wire)")
        if quant_spec is not None and n_aggregators:
            raise ValueError(
                "secure_quant does not compose with --n_aggregators: its "
                "mask slots ride as PRG seeds, and any node holding a "
                "client's seeds can expand every non-data slot — the "
                "grouped deployment's no-single-node property would be "
                "void. Use the dense --secure protocol for grouped "
                "aggregation (see ARCHITECTURE.md 'Privacy plane')")
        super().__init__(init_params, comm_round, num_clients,
                         world_size=num_clients + 1 + n_aggregators, **kw)
        self.quant_spec = quant_spec
        if quant_spec is not None:
            from neuroimagedisttraining_tpu_torch.privacy import (
                check_headroom,
            )

            check_headroom(quant_spec, num_clients)
        self.frac_bits = frac_bits
        self.n_aggregators = n_aggregators
        self._sq_acc = None
        #: with record_trace, every slot-accumulator state after a fold
        self.sq_trace: list = [] if record_trace else None
        self._slot_acc: dict | None = None
        self._n_by_client: dict[int, float] = {}
        self._slot_totals: dict[int, dict] = {}
        #: "A" collects sample counts, "B" share uploads
        self._phase = "A"
        #: the weight sent to each phase-A reporter this round
        self._weights_sent: dict[int, float] = {}
        #: silos whose whole share set folded this round
        self._folded: set[int] = set()
        #: with record_trace, every aggregator total this server saw
        self.record_trace = record_trace
        self.received_totals: list = []

    def register_message_receive_handlers(self) -> None:
        super().register_message_receive_handlers()
        self.register_message_receive_handler(
            M.MSG_TYPE_C2S_NUM_SAMPLES, self._on_num_samples)
        self.register_message_receive_handler(
            M.MSG_TYPE_A2S_SLOT_TOTAL, self._on_slot_total)

    # ---- phase A: sample counts -> normalized weights ----

    def _on_num_samples(self, msg: M.Message) -> None:
        with self._rlock:
            r = msg.get(M.ARG_ROUND_IDX)
            if ((r is not None and int(r) != self.round_idx)
                    or self._phase != "A"
                    or msg.sender_id in self._n_by_client):
                log.warning("server: dropping stale/duplicate sample "
                            "count from %d", msg.sender_id)
                return
            self._n_by_client[msg.sender_id] = float(
                msg.get(M.ARG_NUM_SAMPLES))
            self._last_beat[msg.sender_id] = time.monotonic()
            self._suspect.discard(msg.sender_id)
            self._maybe_complete()

    def _send_agg_weights(self) -> None:
        """Under ``_rlock``: close phase A (weights normalized over the
        reporters) and open phase B with a fresh deadline."""
        total = max(sum(self._n_by_client.values()), 1e-12)
        self._weights_sent = {c: n / total
                              for c, n in self._n_by_client.items()}
        for c, w in self._weights_sent.items():
            out = M.Message(M.MSG_TYPE_S2C_AGG_WEIGHTS, 0, c)
            out.add(M.ARG_AGG_WEIGHT, w)
            out.add(M.ARG_ROUND_IDX, self.round_idx)
            self._send_tolerant(out)
        self._n_by_client.clear()
        self._phase = "B"
        self._arm_deadline()

    # ---- phase B: slot-major share accumulation ----

    def _on_model(self, msg: M.Message) -> None:
        with self._rlock:
            if self._done.is_set():
                return
            r = msg.get(M.ARG_ROUND_IDX)
            if (self._phase != "B"
                    or (r is not None and int(r) != self.round_idx)
                    or msg.sender_id in self._folded
                    or msg.sender_id not in self._weights_sent):
                log.warning("server: dropping stale/duplicate/unweighted "
                            "share upload from %d (round %s, current %d)",
                            msg.sender_id, r, self.round_idx)
                return
            self._fold_shares(msg)
            self._last_beat[msg.sender_id] = time.monotonic()
            self._suspect.discard(msg.sender_id)
            self._maybe_complete()

    def _maybe_complete(self) -> None:
        """Under ``_rlock``: advance the phase as soon as every expected,
        non-suspect peer reported (the quorum floor holds)."""
        floor = min(self.quorum, self.num_clients)
        if self._phase == "A":
            expected = set(range(1, self.num_clients + 1)) - self._suspect
            have = set(self._n_by_client)
            if have and expected <= have and len(have) >= floor:
                self._send_agg_weights()
        else:
            expected = set(self._weights_sent) - self._suspect
            if (self._folded and expected <= self._folded
                    and len(self._folded) >= floor):
                self._finalize_secure()

    def _fold_shares(self, msg: M.Message) -> None:
        from neuroimagedisttraining_tpu_torch.ops import mpc

        if self.quant_spec is not None:
            from neuroimagedisttraining_tpu_torch.privacy import (
                SlotAccumulator,
            )

            if self._sq_acc is None:
                # like= fixes the leaf structure, so a skewed frame is
                # refused before any accumulator changes
                self._sq_acc = SlotAccumulator(self.quant_spec,
                                               trace=self.sq_trace,
                                               like=self.params)
            try:
                # the frame folds whole or not at all; a refused one
                # leaves its sender a straggler
                self._sq_acc.fold(msg.get(M.ARG_MODEL_PARAMS))
            except (ValueError, KeyError, TypeError) as e:
                log.warning("server: dropping invalid secure-quant frame "
                            "from %d (round %d): %s", msg.sender_id,
                            self.round_idx, e)
                return
            self._folded.add(msg.sender_id)
            return
        shares_tree = msg.get(M.ARG_MODEL_PARAMS)  # leaves [n_shares, ...]
        if self._slot_acc is None:
            self._slot_acc = tree_map(
                lambda s: np.asarray(s, np.int64) % mpc.P_DEFAULT,
                shares_tree)
        else:
            self._slot_acc = tree_map(
                lambda acc, s: (acc + np.asarray(s, np.int64))
                % mpc.P_DEFAULT, self._slot_acc, shares_tree)
        self._folded.add(msg.sender_id)

    def _finalize_secure(self) -> None:
        """Under ``_rlock``: combine the slots and dequantize; a phase-A
        reporter that dropped before phase B leaves the survivors' weights
        summing to W < 1, so the result is re-weighted by 1 / W."""
        from neuroimagedisttraining_tpu_torch.ops import mpc

        if self._timer is not None:
            self._timer.cancel()
        t0 = time.perf_counter()
        w_sum = sum(self._weights_sent.get(c, 0.0) for c in self._folded)
        rescale = (1.0 / w_sum
                   if self._folded != set(self._weights_sent) and w_sum > 0
                   else 1.0)
        if self.quant_spec is not None:
            from neuroimagedisttraining_tpu_torch.privacy.secure_quant import (
                leaf_scales,
            )

            # self.params is still the round's broadcast: the scales every
            # uploading silo derived from its sync
            self.params = self._sq_acc.finalize(
                like=self.params, rescale=rescale,
                scales=leaf_scales(self.params))
            self._sq_acc = None
        else:
            self.params = tree_map(
                lambda slots, old: (rescale * mpc.dequantize(
                    np.mod(slots.sum(axis=0), mpc.P_DEFAULT),
                    frac_bits=self.frac_bits)).astype(
                        np.asarray(old).dtype),
                self._slot_acc, self.params)
            self._slot_acc = None
        self.aggregate_seconds.append(time.perf_counter() - t0)
        survivors = sorted(self._folded)
        if self.quant_spec is not None and self.defense == "weak_dp" \
                and survivors:
            # the noise went in on the silos; the ledger stays here
            self._dp_round_info = self._note_weak_dp(
                survivors, [self._weights_sent.get(c, 0.0)
                            for c in survivors])
        self._folded = set()
        self._weights_sent = {}
        self._phase = "A"
        self._complete_round(len(survivors), survivors=survivors)

    def _on_deadline(self, round_for: int, gen: int) -> None:
        with self._rlock:
            if self._deadline_stale(round_for, gen):
                return
            floor = min(self.quorum, self.num_clients)
            if self._phase == "A":
                if self._n_by_client and len(self._n_by_client) >= floor:
                    self._mark_missing_suspect(set(self._n_by_client))
                    log.warning("server: round %d phase-A deadline - "
                                "weighting %d/%d reporters", round_for,
                                len(self._n_by_client), self.num_clients)
                    self._send_agg_weights()
                else:
                    self._arm_deadline()
            else:
                if self._folded and len(self._folded) >= floor:
                    self._mark_missing_suspect(set(self._folded))
                    log.warning("server: round %d phase-B deadline - "
                                "aggregating %d/%d survivors", round_for,
                                len(self._folded), self.num_clients)
                    self._finalize_secure()
                else:
                    self._arm_deadline()

    # ---- phase B': aggregator slot totals (n_aggregators > 0) ----
    # the grouped deployment needs all K totals (one missing slot
    # destroys the sharing), so the deadline and quorum apply to the
    # single-server mode only: a dropped silo stalls the aggregators

    def _on_slot_total(self, msg: M.Message) -> None:
        from neuroimagedisttraining_tpu_torch.ops import mpc

        with self._rlock:
            total = msg.get(M.ARG_MODEL_PARAMS)
            if self.record_trace:
                self.received_totals.append(total)
            self._slot_totals[int(msg.get(M.ARG_SLOT_INDEX))] = total
            if len(self._slot_totals) < self.n_aggregators:
                return
            t0 = time.perf_counter()
            totals = [self._slot_totals[j]
                      for j in sorted(self._slot_totals)]
            self.params = tree_map(
                lambda old, *slots: mpc.dequantize(
                    np.mod(sum(np.asarray(s, np.int64) for s in slots),
                           mpc.P_DEFAULT),
                    frac_bits=self.frac_bits).astype(
                        np.asarray(old).dtype),
                self.params, *totals)
            self.aggregate_seconds.append(time.perf_counter() - t0)
            self._slot_totals.clear()
            # the next round's sample counts pass the phase-A gate
            self._weights_sent = {}
            self._folded = set()
            self._phase = "A"
            self._complete_round(self.num_clients)

    def _broadcast_finish(self) -> None:
        super()._broadcast_finish()
        for j in range(self.n_aggregators):
            self.send_message(M.Message(M.MSG_TYPE_S2C_FINISH, 0,
                                        self.num_clients + 1 + j))


class SlotAggregatorProc(ClientManager):
    """Aggregator j (rank ``num_clients + 1 + j``): receives ONLY slot j of
    every silo's sharing a round, folds the slots mod p over the silos and
    sends the server the one total. A slot is uniform in GF(p) and reveals
    nothing of a silo; the total reveals the slot's sum over silos."""

    def __init__(self, slot_index: int, num_clients: int,
                 n_aggregators: int, record_trace: bool = False, **kw):
        super().__init__(rank=num_clients + 1 + slot_index,
                         world_size=num_clients + 1 + n_aggregators, **kw)
        self.slot_index = slot_index
        self.num_clients = num_clients
        self._acc = None
        self._clients_in = 0
        #: with record_trace, every share received by sender (tests read
        #: what this process could learn); the senders are always kept
        self.record_trace = record_trace
        self.received: dict[int, list] = {}

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            M.MSG_TYPE_C2A_SEND_SLOT, self._on_slot)
        self.register_message_receive_handler(
            M.MSG_TYPE_S2C_FINISH, lambda msg: self.finish())

    def _on_slot(self, msg: M.Message) -> None:
        from neuroimagedisttraining_tpu_torch.ops import mpc

        slot = msg.get(M.ARG_MODEL_PARAMS)
        lst = self.received.setdefault(msg.sender_id, [])
        if self.record_trace:
            lst.append(slot)
        if self._acc is None:
            self._acc = tree_map(
                lambda s: np.asarray(s, np.int64) % mpc.P_DEFAULT, slot)
        else:
            self._acc = tree_map(
                lambda a, s: (a + np.asarray(s, np.int64)) % mpc.P_DEFAULT,
                self._acc, slot)
        self._clients_in += 1
        if self._clients_in < self.num_clients:
            return
        out = M.Message(M.MSG_TYPE_A2S_SLOT_TOTAL, self.rank, 0)
        out.add(M.ARG_MODEL_PARAMS, self._acc)
        out.add(M.ARG_SLOT_INDEX, self.slot_index)
        self.send_message(out)
        self._acc = None
        self._clients_in = 0


# ---------------------------------------------------------------------------
# the silo
# ---------------------------------------------------------------------------

class FedAvgClientProc(ClientManager):
    """Rank >= 1: trains through ``train_fn`` on every sync.

    ``heartbeat_interval`` > 0 beats to the server every interval. Uploads
    carry the sync's round, a monotone ``ARG_UPLOAD_SEQ`` and a wire trace
    context (``obs.trace.make_trace_ctx``).

    ``wire_codec`` encodes every upload (``codec/wire.py``): delta against
    the sync just received, mask-sparse against ``wire_masks`` (no bitmap:
    the server holds the same mask), or top-k with this silo's error
    feedback carried across rounds. The top-k threshold comes from
    ``ops/topk.kth_largest`` on ``device`` (:class:`CodecThreshold`); the
    frame is packed on the host. A sync with ``ARG_EF_RESET`` clears the
    error feedback first.

    ``sync_delta``: the silo registers with ``ARG_SYNC_DELTA_OK`` and takes
    a sync body that is the byte delta against the model it holds
    (``codec/wire.encode_sync_delta``); a sync with no body reuses the
    model it holds (:meth:`_resolve_sync_params`).

    ``fault_schedule`` + ``seed``: a silo the schedule makes Byzantine
    transforms its own upload (``faults/adversary.py``) before encoding,
    its Gaussian draws ``core/robust.noise_draws``'s.

    Training holds the device's :func:`train_lock`: silos trained as
    threads of one process share the device's graph stream. With
    ``record_uploads`` (a list), each codec upload appends ``(round,
    trained tree, reference tree, error feedback before, frame)``."""

    #: monotone upload counter (ARG_UPLOAD_SEQ)
    _upload_seq = 0

    def __init__(self, rank: int, num_clients: int,
                 train_fn: Callable, world_size: int | None = None,
                 heartbeat_interval: float = 0.0, wire_codec: str = "none",
                 wire_masks=None, wire_topk_ratio: float = 0.25,
                 fault_schedule=None, seed: int = 0,
                 sync_delta: bool = False, device="cuda",
                 record_uploads: list | None = None, **kw):
        device = silo_device(device)
        super().__init__(rank=rank, world_size=world_size or num_clients + 1,
                         **kw)
        self.num_clients = num_clients
        self.train_fn = train_fn
        self.heartbeat_interval = float(heartbeat_interval)
        self.final_params = None
        self.device = device
        self._hb_stop = threading.Event()
        self._wire_spec = codec.parse_wire_spec(wire_codec, wire_topk_ratio)
        self.wire_masks = (to_numpy_tree(wire_masks)
                           if wire_masks is not None else None)
        self._wire_ef = None  # this silo's error feedback, by leaf name
        self.threshold = CodecThreshold(self.device)
        self.record_uploads = record_uploads
        #: the seconds of each round's train_fn (inside the train lock),
        #: of its wait for that lock and of its upload's encode
        self.train_seconds: list[float] = []
        self.lock_wait_seconds: list[float] = []
        self.encode_seconds: list[float] = []
        self.fault_schedule = fault_schedule
        self.seed = int(seed)
        #: the last full model synced, reused when a sync at an unchanged
        #: version comes without a body (the ingest workers' replies)
        self._last_sync_params = None
        #: take lossless delta sync bodies (asynchronous plane): a
        #: changed-version reply may then ship the byte delta against the
        #: version named in ``_last_sync_version``
        self.sync_delta = bool(sync_delta)
        self._last_sync_version = -1

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            M.MSG_TYPE_S2C_INIT_CONFIG, self._on_sync)
        self.register_message_receive_handler(
            M.MSG_TYPE_S2C_SYNC_MODEL, self._on_sync)
        self.register_message_receive_handler(
            M.MSG_TYPE_S2C_FINISH, self._on_finish)

    def run(self) -> None:
        self.register_message_receive_handlers()
        reg = M.Message(M.MSG_TYPE_C2S_REGISTER, self.rank, 0)
        # this process's lifetime is the incarnation
        reg.add(M.ARG_CLIENT_INCARNATION, os.getpid())
        if self.sync_delta:
            reg.add(M.ARG_SYNC_DELTA_OK, True)
        # the server may still be building its model: the first contact
        # gets a long retry window where the transport has one
        try:
            self.com_manager.send_message(reg, retries=150,
                                          retry_delay=0.25)
        except TypeError:  # transport without retry knobs (broker)
            self.com_manager.send_message(reg)
        if self.heartbeat_interval > 0:
            threading.Thread(target=self._heartbeat_loop,
                             daemon=True).start()
        self.com_manager.handle_receive_message()
        self._hb_stop.set()  # finished or crashed

    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.wait(self.heartbeat_interval):
            beat = M.Message(M.MSG_TYPE_C2S_HEARTBEAT, self.rank, 0)
            try:
                try:
                    self.com_manager.send_message(beat, retries=1)
                except TypeError:
                    self.com_manager.send_message(beat)
            except Exception:  # noqa: BLE001 — liveness is best effort
                pass

    def _train(self, params, round_idx: int):
        t_wait = time.perf_counter()
        with train_lock(self.device):
            t0 = time.perf_counter()
            new_params, n = self.train_fn(params, round_idx)
            self.train_seconds.append(time.perf_counter() - t0)
        self.lock_wait_seconds.append(t0 - t_wait)
        return to_numpy_tree(new_params), n

    def _attack(self, payload, params, round_idx: int):
        """The value-fault hook, before any encoding: the schedule's attack
        of this rank and round on its upload (an honest plan returns the
        upload as it is)."""
        import torch

        from neuroimagedisttraining_tpu_torch.core import robust
        from neuroimagedisttraining_tpu_torch.faults import adversary

        mult, std, nan = adversary.kind_params(
            self.fault_schedule.byzantine_kind(round_idx, self.rank))
        if adversary.is_honest(mult, std, nan):
            return payload
        up = {k: torch.as_tensor(np.ascontiguousarray(v))
              for k, v in named_leaves(payload).items()}
        ref = {k: torch.as_tensor(np.ascontiguousarray(v))
               for k, v in named_leaves(params).items()}
        noise = (robust.noise_draws(self.seed, "attack", round_idx,
                                    self.rank - 1, up)
                 if std != 0.0 else None)
        out = adversary.apply_attack(up, ref, mult, std, nan, noise)
        return codec.nest({k: v.numpy() for k, v in out.items()})

    def _resolve_sync_params(self, msg: M.Message, round_idx: int):
        """The sync's model. A sync at an unchanged version may come
        without a body (an ingest worker's reply): this silo holds that
        tree from its previous sync; with none held it is a protocol error
        and the sync is dropped (None). Under ``sync_delta`` a changed
        version may come as the byte delta against the version this silo
        last synced, decoded against the held tree bit for bit; a delta
        naming any other base is dropped loudly, never applied."""
        params = msg.get(M.ARG_MODEL_PARAMS)
        if params is None:
            if self._last_sync_params is None:
                log.error("silo %d: body-less sync at version %d with no "
                          "cached model - dropping the sync", self.rank,
                          round_idx)
                return None
            return self._last_sync_params
        if codec.is_sync_delta_frame(params):
            base_v = int(params.get("base", -1))
            if (self._last_sync_params is None
                    or base_v != self._last_sync_version):
                log.error(
                    "silo %d: sync delta at version %d names base %d "
                    "but this silo holds %d - dropping the sync",
                    self.rank, round_idx, base_v,
                    self._last_sync_version)
                return None
            params = codec.decode_sync_delta(params,
                                             self._last_sync_params)
        self._last_sync_params = params
        self._last_sync_version = int(round_idx)
        return params

    def _on_sync(self, msg: M.Message) -> None:
        round_idx = int(msg.get(M.ARG_ROUND_IDX))
        params = self._resolve_sync_params(msg, round_idx)
        if params is None:
            return
        if msg.get(M.ARG_EF_RESET):
            log.info("silo %d: server requested ef_reset (round %d) - "
                     "clearing the codec error-feedback accumulator",
                     self.rank, round_idx)
            self._wire_ef = None
        payload, n = self._train(params, round_idx)
        if self.fault_schedule is not None:
            payload = self._attack(payload, params, round_idx)
        if self._wire_spec is not None:
            t0 = time.perf_counter()
            upload_finite = tree_all_finite(payload)
            named = named_leaves(payload)
            ref = named_leaves(params)
            masks = (named_leaves(self.wire_masks)
                     if self.wire_masks is not None else None)
            ef_before = self._wire_ef
            frame, ef_next = codec.encode_update(
                self._wire_spec, named, reference=ref, masks=masks,
                ef=ef_before, mask_on_wire=False,
                threshold_fn=self.threshold)
            if self.record_uploads is not None:
                self.record_uploads.append((round_idx, named, ref,
                                            ef_before, frame))
            # a non-finite upload bounces at the server: its residual
            # would park NaN in the error feedback for good, so the
            # feedback goes (the frame it fed was never aggregated)
            self._wire_ef = ef_next if upload_finite else None
            payload = frame
            self.encode_seconds.append(time.perf_counter() - t0)
        out = M.Message(M.MSG_TYPE_C2S_SEND_MODEL, self.rank, 0)
        out.add(M.ARG_MODEL_PARAMS, payload)
        out.add(M.ARG_NUM_SAMPLES, float(n))
        out.add(M.ARG_ROUND_IDX, round_idx)
        out.add(M.ARG_UPLOAD_SEQ, self._upload_seq)
        # the silo originates the upload's flow: every later hop links
        # its events to this id
        ctx = obs_trace.make_trace_ctx(self.rank, self._upload_seq)
        out.add(M.ARG_TRACE_CTX, ctx)
        self._upload_seq += 1
        if obs_trace.TRACER.armed:
            with obs_trace.span("client_upload", round=round_idx):
                obs_trace.flow("upload", obs_trace.flow_id_of(ctx), "s",
                               round=round_idx)
                self.send_message(out)
        else:
            self.send_message(out)

    def _on_finish(self, msg: M.Message) -> None:
        self.final_params = None  # the server holds the aggregate
        self._hb_stop.set()
        self.finish()


class SecureFedAvgClientProc(FedAvgClientProc):
    """The silo of ``SecureFedAvgServer``: after training it reports
    ``n_c``, waits for its weight ``w_c``, then uploads additive shares of
    ``quantize(w_c * params)`` (``w_c <= 1`` keeps the fixed-point
    embedding exact for any cohort); or, with ``quant_spec``, one
    field-element frame (``privacy/secure_quant.py``). The clip family
    (``defense``, with ``quant_spec`` only) runs on its own update before
    it shares: ``core/robust.norm_diff_clip`` against the sync, then
    ``add_weak_dp_noise`` with draws keyed by (defense_seed, round, rank,
    leaf) (:func:`silo_noise`). ``one_phase`` (the asynchronous plane,
    ``quant_spec`` only): no weight exchange; the silo ships the frame of
    its unweighted update and ``n`` in the clear at once."""

    def __init__(self, rank: int, num_clients: int, train_fn: Callable,
                 n_shares: int = 3, frac_bits: int = 16, mpc_seed: int = 0,
                 n_aggregators: int = 0, quant_spec=None,
                 one_phase: bool = False, defense: str = "none",
                 norm_bound: float = 5.0, stddev: float = 0.05,
                 defense_seed: int = 0, **kw):
        from neuroimagedisttraining_tpu_torch.core import robust

        if n_aggregators and n_aggregators != n_shares:
            raise ValueError(
                f"n_aggregators ({n_aggregators}) must equal n_shares "
                f"({n_shares}): slot j routes to aggregator j")
        if n_aggregators and quant_spec is not None:
            raise ValueError(
                "secure_quant does not compose with --n_aggregators "
                "(seed-expanded mask slots; see SecureFedAvgServer)")
        if kw.get("wire_codec", "none") != "none" or \
                kw.get("wire_masks") is not None:
            raise ValueError(
                "SecureFedAvgClientProc is incompatible with the wire "
                "codec: secure uploads must ride the wire as field "
                "elements (see SecureFedAvgServer — encoding breaks the "
                "GF(p) share algebra or leaks mask support; "
                "--secure_quant IS the compressed secure wire)")
        sched = kw.get("fault_schedule")
        if sched is not None and sched.spec.any_value_faults:
            raise ValueError(
                "byz: value faults cannot be simulated under --secure: "
                "the secure client's upload path shares BEFORE any "
                "value hook could run, and the server has no plaintext "
                "updates to defend — the attack would go both "
                "uninjected and undefended (see ARCHITECTURE.md)")
        if one_phase and quant_spec is None:
            raise ValueError(
                "one_phase (the async buffered protocol) requires a "
                "quant_spec: the dense two-phase weight exchange IS a "
                "round barrier (see asyncfl/server.py)")
        if defense != "none":
            robust.validate_defense(defense)
            if quant_spec is None or defense not in robust.CLIP_DEFENSES:
                raise ValueError(
                    f"client-side defense {defense!r} composes only with "
                    "secure_quant and only for the clip family "
                    "(norm_diff_clipping, weak_dp) — each silo clips/"
                    "noises its OWN update before sharing; see "
                    "ARCHITECTURE.md 'Privacy plane'")
        super().__init__(rank, num_clients, train_fn,
                         world_size=num_clients + 1 + n_aggregators, **kw)
        self.n_shares = n_shares
        self.frac_bits = frac_bits
        self.n_aggregators = n_aggregators
        self.quant_spec = quant_spec
        self.one_phase = bool(one_phase)
        self.defense = defense
        self.norm_bound = float(norm_bound)
        self.stddev = float(stddev)
        self.defense_seed = int(defense_seed)
        self._rng = np.random.default_rng(mpc_seed * 7919 + rank)
        self._trained = None  # trained tree awaiting its weight
        self._sync_ref = None  # the sync (the clip's baseline)

    def register_message_receive_handlers(self) -> None:
        super().register_message_receive_handlers()
        self.register_message_receive_handler(
            M.MSG_TYPE_S2C_AGG_WEIGHTS, self._on_weights)

    def _client_side_defense(self, trained, round_idx: int):
        """The clip family on this silo's own update, before it is
        quantized and shared."""
        if self.defense == "none" or self._sync_ref is None:
            return trained
        import torch

        from neuroimagedisttraining_tpu_torch.core import robust

        up = {k: torch.as_tensor(np.asarray(v, np.float32))
              for k, v in named_leaves(trained).items()}
        ref = {k: torch.as_tensor(np.asarray(v, np.float32))
               for k, v in named_leaves(self._sync_ref).items()}
        out = robust.norm_diff_clip(up, ref, self.norm_bound)
        if self.defense == "weak_dp":
            out = robust.add_weak_dp_noise(
                out, silo_noise(self.defense_seed, round_idx, self.rank,
                                out), self.stddev)
        return codec.nest({k: v.numpy() for k, v in out.items()})

    def _sq_upload(self, payload, round_idx, weight: float) -> None:
        """One secure-quant frame (the round's one upload: it folds whole
        or not at all), scaled by ``leaf_scales`` of the sync both ends
        hold."""
        from neuroimagedisttraining_tpu_torch.privacy import (
            encode_secure_quant,
        )
        from neuroimagedisttraining_tpu_torch.privacy.secure_quant import (
            leaf_scales,
        )

        frame = encode_secure_quant(payload, weight, self.quant_spec,
                                    self._rng,
                                    scales=leaf_scales(self._sync_ref))
        out = M.Message(M.MSG_TYPE_C2S_SEND_MODEL, self.rank, 0)
        out.add(M.ARG_MODEL_PARAMS, frame)
        if round_idx is not None:
            out.add(M.ARG_ROUND_IDX, int(round_idx))
        out.add(M.ARG_UPLOAD_SEQ, self._upload_seq)
        self._upload_seq += 1
        self.send_message(out)

    def _on_sync(self, msg: M.Message) -> None:
        round_idx = int(msg.get(M.ARG_ROUND_IDX))
        params = self._resolve_sync_params(msg, round_idx)
        if params is None:
            return
        new_params, n = self._train(params, round_idx)
        self._sync_ref = to_numpy_tree(params)
        trained = self._client_side_defense(new_params, round_idx)
        if self.one_phase:
            # the asynchronous plane: no weight exchange (a round
            # barrier); the unweighted quantized update and n in the
            # clear, the server folding the staleness weights inside the
            # field (asyncfl/server.py)
            from neuroimagedisttraining_tpu_torch.privacy import (
                encode_secure_quant,
            )

            frame = encode_secure_quant(trained, 1.0, self.quant_spec,
                                        self._rng)
            out = M.Message(M.MSG_TYPE_C2S_SEND_MODEL, self.rank, 0)
            out.add(M.ARG_MODEL_PARAMS, frame)
            out.add(M.ARG_NUM_SAMPLES, float(n))
            out.add(M.ARG_ROUND_IDX, round_idx)
            out.add(M.ARG_UPLOAD_SEQ, self._upload_seq)
            self._upload_seq += 1
            self.send_message(out)
            return
        self._trained = trained
        out = M.Message(M.MSG_TYPE_C2S_NUM_SAMPLES, self.rank, 0)
        out.add(M.ARG_NUM_SAMPLES, float(n))
        out.add(M.ARG_ROUND_IDX, round_idx)
        self.send_message(out)

    def _on_weights(self, msg: M.Message) -> None:
        from neuroimagedisttraining_tpu_torch.ops import mpc

        round_idx = msg.get(M.ARG_ROUND_IDX)
        w = float(msg.get(M.ARG_AGG_WEIGHT))
        if self.quant_spec is not None:
            payload, self._trained = self._trained, None
            self._sq_upload(payload, round_idx, w)
            return
        shares_tree = tree_map(
            lambda x: mpc.additive_shares(
                mpc.quantize(w * np.asarray(x, np.float64),
                             frac_bits=self.frac_bits),
                self.n_shares, rng=self._rng),
            self._trained)
        self._trained = None
        if self.n_aggregators:
            # slot j -> aggregator j: no node holds two of this silo's
            # slots
            for j in range(self.n_aggregators):
                out = M.Message(M.MSG_TYPE_C2A_SEND_SLOT, self.rank,
                                self.num_clients + 1 + j)
                out.add(M.ARG_MODEL_PARAMS,
                        tree_map(lambda s: s[j], shares_tree))
                out.add(M.ARG_SLOT_INDEX, j)
                if round_idx is not None:
                    out.add(M.ARG_ROUND_IDX, int(round_idx))
                self.send_message(out)
            return
        out = M.Message(M.MSG_TYPE_C2S_SEND_MODEL, self.rank, 0)
        out.add(M.ARG_MODEL_PARAMS, shares_tree)
        if round_idx is not None:
            out.add(M.ARG_ROUND_IDX, int(round_idx))
        self.send_message(out)
