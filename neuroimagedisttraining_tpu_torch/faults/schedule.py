"""Seeded fault schedule: a pure function of ``(seed, round, rank)``.

Every decision comes from ``np.random.default_rng`` seeded with the whole
coordinate of the event, ``(seed, stream, round, rank[, seq])``: no global
numpy stream, no OS entropy. So the fault trace replays bit for bit from
the config seed in any process and in any order of queries (the reference
package's ``faults/schedule.py``, which this copies).

Ranks are numbered as across silos: rank 0 is the server and clients are
ranks ``1..num_clients``; the engines map client index ``c`` to rank
``c + 1`` (``FederatedEngine.client_sampling`` keeps the survivors).

The comm-level draws (straggle, drop, dup, disconnect) are kept for the
trace; the in-process engines have no messages to act on. ``preempt:``
parses (the grammar is the reference's), and the engines refuse it: the
port has no elastic device plane.

``activity_mask`` is DisPFL's Bernoulli activity draw.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

# sub-stream tags: distinct event kinds never share an RNG stream
_STREAM_CRASH = 1
_STREAM_STRAGGLE = 2
_STREAM_DROP = 3
_STREAM_DUP = 4
_STREAM_DISCONNECT = 5
_STREAM_BYZ = 6

#: value-fault kinds a Byzantine client can inject (faults/adversary.py
#: realizes them as transforms of the uploads). ``scale`` and ``gauss``
#: carry a parameter: ``scale:K`` / ``gauss:STD``.
BYZ_KINDS = ("sign_flip", "scale", "gauss", "nonfinite")


def parse_byz_kind(text: str) -> str:
    """Validate a byz KIND token (``sign_flip | scale:K | gauss:STD |
    nonfinite``) and return it canonicalized. Raises ValueError on
    anything else — a typo'd attack kind must fail at config parse, not
    mid-round."""
    text = text.strip()
    name, _, param = text.partition(":")
    name = name.strip()
    if name not in BYZ_KINDS:
        raise ValueError(
            f"unknown byz kind {text!r}; one of sign_flip | scale:K | "
            "gauss:STD | nonfinite")
    if name in ("scale", "gauss"):
        if not param:
            raise ValueError(
                f"byz kind {name!r} needs a parameter ({name}:VALUE)")
        val = float(param)  # raises ValueError on garbage
        if name == "gauss" and val < 0:
            raise ValueError(f"byz gauss std must be >= 0, got {val}")
        return f"{name}:{val}"
    if param:
        raise ValueError(f"byz kind {name!r} takes no parameter "
                         f"(got {text!r})")
    return name


def activity_mask(seed: int, round_idx: int, n: int,
                  active_prob: float) -> np.ndarray:
    """DisPFL's per-round Bernoulli(active) draw, bit-identical to the
    engine's historical inline formula (engines/dispfl.py active_draw):
    one generator seeded ``seed * 100003 + round_idx``, one uniform per
    client."""
    rng = np.random.default_rng(seed * 100003 + round_idx)
    return rng.random(n) < active_prob


@dataclass(frozen=True)
class FaultSpec:
    """What can go wrong. All probabilities are per-event Bernoulli
    parameters; ``crashes`` adds deterministic (rank, round) kill points
    on top of the probabilistic draw, and ``rejoins`` ends a
    deterministic crash window (crash **and** come back)."""

    crashes: tuple[tuple[int, int], ...] = ()  # (rank, round): dead from round on
    # (rank, round): alive again from round on — must follow a ``crashes``
    # directive for the same rank at an earlier round (parse-validated);
    # probabilistic crash_prob deaths stay permanent (no seeded stream
    # could decide WHICH probabilistic corpse a rejoin revives)
    rejoins: tuple[tuple[int, int], ...] = ()
    crash_prob: float = 0.0        # per-(round, rank); crashes are permanent
    straggle_prob: float = 0.0     # per-(round, rank)
    straggle_delay: float = 0.0    # max seconds; actual ~ U(0, max)
    drop_prob: float = 0.0         # per outbound protocol message
    dup_prob: float = 0.0          # per outbound protocol message
    disconnect_prob: float = 0.0   # mid-frame disconnect per outbound message
    # value faults (Byzantine clients, faults/adversary.py): (rank,
    # round, kind) — the client uploads adversarially transformed
    # updates from ``round`` on (a compromised silo stays compromised,
    # same permanence as ``crashes``); byz_prob draws a per-(round,
    # rank) transient corruption of ``byz_kind`` instead
    byz: tuple[tuple[int, int, str], ...] = ()
    byz_prob: float = 0.0
    byz_kind: str = "sign_flip"
    # device preemption: (round, ndev) — at ROUND the training mesh
    # loses devices down to NDEV survivors. A compute-plane fault: it
    # never corrupts upload values (any_value_faults excludes it) and
    # never touches the client-liveness streams. The port's engines
    # refuse it (no elastic plane).
    preempts: tuple[tuple[int, int], ...] = ()

    def __post_init__(self) -> None:
        # a rejoin without an earlier deterministic crash for the same
        # rank is a spec typo (the rank was never scheduled dead) — fail
        # at parse/construction, never mid-run
        for rank, at in self.rejoins:
            if not any(r == rank and cr < at for r, cr in self.crashes):
                raise ValueError(
                    f"rejoin:{rank}@{at} has no crash:{rank}@ROUND "
                    f"directive with ROUND < {at} to rejoin from")
            if any(r == rank and cr == at for r, cr in self.crashes):
                # a tie would make the event walk order-dependent —
                # the 'rounds never tie' invariant crashed() relies on
                raise ValueError(
                    f"crash:{rank}@{at} and rejoin:{rank}@{at} share a "
                    "round; crash/rejoin directives for one rank must "
                    "alternate at distinct rounds")

    @property
    def any_faults(self) -> bool:
        return bool(self.crashes) or bool(self.byz) \
            or bool(self.preempts) or any(
            p > 0 for p in (self.crash_prob, self.straggle_prob,
                            self.drop_prob, self.dup_prob,
                            self.disconnect_prob, self.byz_prob))

    @property
    def any_value_faults(self) -> bool:
        """True iff the spec can corrupt upload VALUES (the engines must
        route updates through faults/adversary.py; omission/timing
        faults never need that)."""
        return bool(self.byz) or self.byz_prob > 0


def parse_fault_spec(text: str) -> FaultSpec:
    """Parse the ``--fault_spec`` mini-grammar: comma/semicolon-separated
    directives::

        crash:RANK@ROUND        deterministic kill of RANK at ROUND
        rejoin:RANK@ROUND       RANK comes back at ROUND (ends a crash
                                window; needs an earlier crash:RANK@R —
                                crash_prob deaths stay permanent)
        crash_prob:P            per-(round, rank) Bernoulli crash
        straggle:P:MAX_DELAY    with prob P delay sends by U(0, MAX_DELAY) s
        drop:P                  drop outbound protocol messages with prob P
        dup:P                   duplicate outbound messages with prob P
        disconnect:P            tear the connection mid-frame with prob P
        byz:RANK@ROUND:KIND     RANK uploads KIND-corrupted values from
                                ROUND on; KIND = sign_flip | scale:K |
                                gauss:STD | nonfinite
        byz_prob:P[:KIND]       per-(round, rank) transient value fault
                                of KIND (default sign_flip)
        preempt:NDEV@ROUND      device preemption: at ROUND the training
                                mesh loses devices down to NDEV
                                survivors (refused by the port's
                                engines: no elastic plane)

    e.g. ``"crash:3@1,rejoin:3@4,drop:0.1,byz:1@0:sign_flip"``. Empty
    string => no faults."""
    crashes: list[tuple[int, int]] = []
    rejoins: list[tuple[int, int]] = []
    byz: list[tuple[int, int, str]] = []
    preempts: list[tuple[int, int]] = []
    kw: dict = {}
    for part in text.replace(";", ",").split(","):
        part = part.strip()
        if not part:
            continue
        key, _, rest = part.partition(":")
        key = key.strip()
        try:
            if key in ("crash", "rejoin"):
                rank_s, _, round_s = rest.partition("@")
                (crashes if key == "crash" else rejoins).append(
                    (int(rank_s), int(round_s)))
            elif key == "byz":
                at, _, kind = rest.partition(":")
                rank_s, _, round_s = at.partition("@")
                if not kind:
                    raise ValueError(
                        "byz needs RANK@ROUND:KIND (e.g. byz:1@0:sign_flip)")
                byz.append((int(rank_s), int(round_s),
                            parse_byz_kind(kind)))
            elif key == "byz_prob":
                p_s, _, kind = rest.partition(":")
                kw["byz_prob"] = float(p_s)
                if kind:
                    kw["byz_kind"] = parse_byz_kind(kind)
            elif key == "straggle":
                p_s, _, d_s = rest.partition(":")
                kw["straggle_prob"] = float(p_s)
                kw["straggle_delay"] = float(d_s)
            elif key == "preempt":
                ndev_s, _, round_s = rest.partition("@")
                ndev, at = int(ndev_s), int(round_s)
                if ndev < 1:
                    raise ValueError(
                        "preempt needs NDEV >= 1 survivors "
                        "(preempt:NDEV@ROUND)")
                preempts.append((at, ndev))
            elif key == "crash_prob":
                kw["crash_prob"] = float(rest)
            elif key in ("drop", "dup", "disconnect"):
                kw[f"{key}_prob"] = float(rest)
            else:
                raise ValueError(f"unknown fault directive {key!r}")
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"bad --fault_spec directive {part!r}: {e}") from None
    for name, p in kw.items():
        if name in ("straggle_delay", "byz_kind"):
            continue
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"--fault_spec {name}={p} not in [0, 1]")
    try:
        return FaultSpec(crashes=tuple(crashes), rejoins=tuple(rejoins),
                         byz=tuple(byz),
                         preempts=tuple(sorted(preempts)), **kw)
    except ValueError as e:  # rejoin-without-crash cross-validation
        raise ValueError(f"bad --fault_spec: {e}") from None


class FaultSchedule:
    """The deterministic chaos oracle. Every query is a pure function of
    ``(seed, round, rank[, msg stream, seq])`` — repeated queries and
    fresh instances over the same spec+seed agree bit-for-bit."""

    def __init__(self, spec: FaultSpec, seed: int):
        self.spec = spec
        self.seed = int(seed)
        #: rank -> [(round, is_crash)] sorted by round; FaultSpec
        #: validation guarantees every rejoin strictly follows a crash,
        #: so rounds never tie and the walk in ``crashed`` is unambiguous
        self._life_events: dict[int, list[tuple[int, bool]]] = {}
        for rank, round_idx in spec.crashes:
            self._life_events.setdefault(rank, []).append((round_idx, True))
        for rank, round_idx in spec.rejoins:
            self._life_events.setdefault(rank, []).append((round_idx, False))
        for events in self._life_events.values():
            events.sort(key=lambda e: (e[0], e[1]))

    # ---- per-(round, rank) event draws ----

    def _draw(self, stream: int, round_idx: int, rank: int,
              seq: int | None = None) -> np.random.Generator:
        coords = [self.seed, stream, int(round_idx), int(rank)]
        if seq is not None:
            coords.append(int(seq))
        return np.random.default_rng(coords)

    def crashed(self, round_idx: int, rank: int) -> bool:
        """True iff ``rank`` is dead at ``round_idx``. Deterministic
        ``crash:``/``rejoin:`` directives form alternating windows (the
        latest directive at or before ``round_idx`` decides); a
        probabilistic ``crash_prob`` death is permanent — the wrapper's
        process is gone, and only an explicit rejoin directive (or the
        control plane's re-register path) models a comeback."""
        dead = False
        for at, is_crash in self._life_events.get(rank, ()):
            if at > round_idx:
                break
            dead = is_crash
        if dead:
            return True
        p = self.spec.crash_prob
        if p > 0:
            for r in range(int(round_idx) + 1):
                if self._draw(_STREAM_CRASH, r, rank).random() < p:
                    return True
        return False

    def crash_round(self, rank: int, horizon: int) -> int | None:
        """First round < horizon at which ``rank`` is dead, or None."""
        for r in range(horizon):
            if self.crashed(r, rank):
                return r
        return None

    def byzantine_kind(self, round_idx: int, rank: int) -> str | None:
        """The value-fault kind ``rank`` injects at ``round_idx``, or
        None when it uploads honestly. Deterministic ``byz:`` directives
        are permanent from their round on (latest directive whose round
        has arrived wins); ``byz_prob`` adds a transient per-(round,
        rank) Bernoulli draw of ``byz_kind`` on its own RNG stream."""
        best: tuple[int, str] | None = None
        for r, at, kind in self.spec.byz:
            if r == rank and round_idx >= at and (
                    best is None or at >= best[0]):
                best = (at, kind)
        if best is not None:
            return best[1]
        p = self.spec.byz_prob
        if p > 0 and self._draw(_STREAM_BYZ, round_idx,
                                rank).random() < p:
            return self.spec.byz_kind
        return None

    def straggle_seconds(self, round_idx: int, rank: int) -> float:
        if self.spec.straggle_prob <= 0 or self.spec.straggle_delay <= 0:
            return 0.0
        rng = self._draw(_STREAM_STRAGGLE, round_idx, rank)
        if rng.random() >= self.spec.straggle_prob:
            return 0.0
        return float(rng.random() * self.spec.straggle_delay)

    # ---- per-message draws (seq = per-(round, msg-type) send index) ----

    def drop(self, round_idx: int, rank: int, seq: int) -> bool:
        return (self.spec.drop_prob > 0 and
                self._draw(_STREAM_DROP, round_idx, rank, seq).random()
                < self.spec.drop_prob)

    def duplicate(self, round_idx: int, rank: int, seq: int) -> bool:
        return (self.spec.dup_prob > 0 and
                self._draw(_STREAM_DUP, round_idx, rank, seq).random()
                < self.spec.dup_prob)

    def disconnect(self, round_idx: int, rank: int, seq: int) -> bool:
        return (self.spec.disconnect_prob > 0 and
                self._draw(_STREAM_DISCONNECT, round_idx, rank,
                           seq).random() < self.spec.disconnect_prob)

    # ---- federation-level views ----

    def survivors(self, round_idx: int, client_indices: np.ndarray
                  ) -> np.ndarray:
        """Filter 0-based engine client indices (rank = index + 1) down
        to those alive at ``round_idx``. If the schedule would kill every
        sampled client the original set is returned unchanged — an empty
        round has no reference semantics and would poison the aggregate
        with a 0/0."""
        alive = np.asarray([not self.crashed(round_idx, int(c) + 1)
                            for c in np.asarray(client_indices)], bool)
        if not alive.any():
            return np.asarray(client_indices)
        return np.asarray(client_indices)[alive]

    def active_mask(self, round_idx: int, n_clients: int,
                    active_prob: float = 1.0) -> np.ndarray:
        """DisPFL-style activity combined with crashes: a client is
        active iff its Bernoulli(active) draw succeeds AND it has not
        crashed. With no crash directives this is bit-identical to the
        historical DisPFL draw."""
        a = activity_mask(self.seed, round_idx, n_clients, active_prob)
        dead = np.asarray([self.crashed(round_idx, c + 1)
                           for c in range(n_clients)], bool)
        return a & ~dead

    def trace(self, rounds: int, ranks: range | list[int],
              msgs_per_round: int = 4) -> list[dict]:
        """Materialize the full event table — the replay artifact tests
        pin (two instances over the same spec+seed must produce equal
        traces)."""
        out = []
        for r in range(rounds):
            for k in ranks:
                out.append({
                    "round": r, "rank": int(k),
                    "crashed": self.crashed(r, k),
                    "byzantine": self.byzantine_kind(r, k),
                    "straggle_s": self.straggle_seconds(r, k),
                    "drop": [self.drop(r, k, s)
                             for s in range(msgs_per_round)],
                    "dup": [self.duplicate(r, k, s)
                            for s in range(msgs_per_round)],
                    "disconnect": [self.disconnect(r, k, s)
                                   for s in range(msgs_per_round)],
                })
        return out

    def describe(self) -> str:
        return (f"FaultSchedule(seed={self.seed}, "
                f"{dataclasses.asdict(self.spec)})")
