"""Secure quantized aggregation: field-element frames over a small GF(p).

Secure aggregation is a sum inside a finite ring, and the ring only needs
to hold the aggregate (Bonawitz et al. 2017): each client quantizes its
update into a small field, masks it there, and the wire carries one small
residue a parameter instead of a stack of int64 share slots.

- **Small field.** With weights that sum to at most 1 the aggregate is a
  weighted mean, so ``|sum_c v_c| < B * 2^frac_bits`` for a value bound B
  that does not grow with the cohort: a 16-bit prime
  (``mpc.FIELD_PRIMES[16] = 65521``) holds it. Single residues may wrap
  (quantization is mod p); only the aggregate needs headroom, which
  ``check_headroom`` checks at startup.
- **Seed-expanded masks.** Of a client's ``n_shares`` additive slots,
  ``n_shares - 1`` are pure randomness and ship as 64-bit generator seeds;
  only the data slot ``q - sum(masks) mod p`` rides the wire as field
  elements. The server expands the seeds again and folds every slot
  slot-major into int64 accumulators: no server-side intermediate equals a
  client's quantized update (``trace`` lets the tests check it). The
  server holds what it would need to unmask one client and is trusted not
  to, as it is trusted not to combine one client's slots in the dense
  protocol.

Wire cost: ``wire_dtype_for(p)`` bytes a parameter plus 8 bytes an extra
share (``frame_nbytes``).

Exactness: the folded, dequantized aggregate equals
``quantized_weighted_mean`` (the plain quantized weighted mean over the
same clients) bit for bit, and the device fold of the engines
(``ops/mpc_device.py`` ``secure_quant_fold``) too: host (``mpc.quantize32``)
and device (``quantize_device``) share the float32 embedding, and the masks
cancel exactly in the field.

Dropout: a client's frame folds whole or not at all, and a client that
drops after the weights were fixed leaves the survivors' weight mass
W < 1, which ``finalize(rescale=1 / W)`` repairs.

A tree here is a dict of arrays, nested (``{"params": {"f0": ...}}``) or
keyed by "/"-joined paths (``"params/f0/conv/kernel"``, the engines'
upload names, ``weights.flax_named_leaves``); its leaves are walked in the
order of their paths, keys sorted at every level, which both ends derive
from the same tree. Host numpy only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

from neuroimagedisttraining_tpu_torch.codec.wire import SECURE_QUANT_KEY
from neuroimagedisttraining_tpu_torch.ops import mpc

Tree = Any

SQ_VERSION = 1

#: the bound on the aggregate's magnitude a coordinate that the startup
#: headroom check assumes: the weighted mean of updates (weights summing to
#: at most 1). 3D-CNN parameters lie in [-1, 1]; 16 leaves a 16x margin and
#: fits the 16-bit field at frac_bits 10 with 2x to spare; beyond it the
#: embedding saturates, sign-preserving (``quantize32``), and never wraps
VALUE_BOUND = 16.0

#: fixed-point bits of the integer fold weights: a weight w folds as
#: ``round(w * 2^WEIGHT_FRAC_BITS)`` inside the field
WEIGHT_FRAC_BITS = 6


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """The field and fixed-point geometry of one deployment. Both ends
    must agree: frames carry the triple and the server checks it at every
    fold."""

    p: int = mpc.FIELD_PRIMES[16]
    frac_bits: int = 10
    n_shares: int = 3

    @staticmethod
    def from_bits(field_bits: int, frac_bits: int = 10,
                  n_shares: int = 3) -> "QuantSpec":
        if field_bits not in mpc.FIELD_PRIMES:
            raise ValueError(
                f"secure_quant_field_bits must be one of "
                f"{sorted(mpc.FIELD_PRIMES)} (got {field_bits})")
        return QuantSpec(p=mpc.FIELD_PRIMES[field_bits],
                         frac_bits=int(frac_bits),
                         n_shares=int(n_shares))

    @property
    def wire_dtype(self) -> np.dtype:
        return mpc.wire_dtype_for(self.p)


def check_headroom(spec: QuantSpec, cohort: int,
                   value_bound: float = VALUE_BOUND) -> None:
    """The startup check of the field geometry (never mid-round): the
    dequantized aggregate must fit the centred field range
    (``value_bound * 2^frac_bits < p / 2``; single residues may wrap, the
    sum may not), the int64 slot accumulators must not overflow over the
    cohort, and the device fold needs ``p < 2^31``."""
    if spec.n_shares < 2:
        raise ValueError(
            f"secure_quant needs n_shares >= 2 (got {spec.n_shares}): one "
            "share is the plaintext")
    if not 1 < spec.p < 1 << 31:
        raise ValueError(f"field modulus {spec.p} outside (1, 2^31)")
    if spec.frac_bits < 1:
        raise ValueError(f"frac_bits must be >= 1, got {spec.frac_bits}")
    agg_range = value_bound * (1 << spec.frac_bits)
    if agg_range >= spec.p // 2:
        raise ValueError(
            f"secure_quant headroom exceeded: aggregate range "
            f"value_bound * 2^frac_bits = {agg_range:.0f} must stay below "
            f"p/2 = {spec.p // 2} — lower secure_quant_frac_bits or raise "
            f"secure_quant_field_bits (p={spec.p}, "
            f"frac_bits={spec.frac_bits})")
    if cohort > 0 and cohort * (spec.p - 1) >= 1 << 62:
        raise ValueError(
            f"slot accumulator headroom exceeded: cohort {cohort} x "
            f"(p-1) overflows int64")


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _paths(tree: Tree, prefix: tuple = ()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + tuple(str(k).split("/")))
    else:
        yield prefix, tree


def _named_leaves(tree: Tree) -> list[tuple[str, Any]]:
    """``(path, leaf)`` of every leaf of a dict tree, paths "/"-joined, in
    path order (keys sorted at every level)."""
    return [("/".join(p), x)
            for p, x in sorted(_paths(tree), key=lambda t: t[0])]


def _rebuild_like(like: Tree, by_name: dict[str, np.ndarray],
                  prefix: tuple = ()) -> Tree:
    """A tree of the structure of ``like`` holding ``by_name``'s leaves."""
    if isinstance(like, dict):
        return {k: _rebuild_like(v, by_name,
                                 prefix + tuple(str(k).split("/")))
                for k, v in like.items()}
    name = "/".join(prefix)
    if name not in by_name:
        raise ValueError(
            f"codec frame is missing leaf {name!r} present in the "
            "template tree — sender/receiver model structures differ")
    return by_name[name]


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def _mask_slot(seed: int, sizes: list[tuple[str, int]],
               p: int) -> dict[str, np.ndarray]:
    """One share seed expanded into uniform GF(p) material a leaf: one
    seeded stream a slot, walked in the frame's leaf order, the same on
    the client and the server."""
    rng = np.random.default_rng(np.uint64(seed))
    return {name: rng.integers(0, p, size=n, dtype=np.int64)
            for name, n in sizes}


def is_secure_quant_frame(obj: Any) -> bool:
    return isinstance(obj, dict) and SECURE_QUANT_KEY in obj


def leaf_scales(reference: Tree,
                value_bound: float = VALUE_BOUND) -> dict[str, float]:
    """Power-of-two scales a leaf from a ``reference`` tree both ends hold
    (the round's broadcast model; the engines: the initial one), so nothing
    more goes on the wire. Values quantize as ``x / scale`` and the
    aggregate is multiplied back; powers of two keep both steps exact.
    Parameters lie well inside ``value_bound``, but BatchNorm running
    statistics track raw activation moments and can reach the hundreds:
    the scale gives each leaf ``2 * max(|ref|, 1)`` of headroom."""
    out = {}
    for name, leaf in _named_leaves(reference):
        m = float(np.max(np.abs(np.asarray(leaf, np.float32)))) \
            if np.asarray(leaf).size else 0.0
        need = 2.0 * max(m, 1.0)
        out[name] = float(2.0 ** math.ceil(math.log2(need / value_bound))) \
            if need > value_bound else 1.0
    return out


def encode_secure_quant(update: Tree, weight: float, spec: QuantSpec,
                        rng: np.random.Generator,
                        scales: dict[str, float] | None = None) -> dict:
    """One client's field-element frame: ``weight * update / scale``
    quantized into GF(p) (``mpc.quantize32``), ``n_shares - 1`` mask seeds
    drawn from the client's own ``rng``, and the data slot ``q -
    sum(masks) mod p`` in the field's wire dtype beside the seeds.
    ``weight``: the normalized FedAvg weight (two-phase protocol), or 1.0
    when the server folds integer weights (one-phase). ``scales``: the
    ``leaf_scales`` both ends derive (None: unscaled)."""
    named = _named_leaves(update)
    sizes = [(name, int(np.asarray(x).size)) for name, x in named]
    seeds = rng.integers(0, np.iinfo(np.uint64).max, size=spec.n_shares - 1,
                         dtype=np.uint64)
    masked = {name: mpc.quantize32(
        np.float32(weight) * np.asarray(x, np.float32).reshape(-1)
        / np.float32(scales[name] if scales else 1.0),
        p=spec.p, frac_bits=spec.frac_bits) for name, x in named}
    for seed in seeds:
        mat = _mask_slot(int(seed), sizes, spec.p)
        masked = {name: np.mod(masked[name] - mat[name], spec.p)
                  for name, _ in sizes}
    leaves = {}
    for name, x in named:
        arr = np.asarray(x)
        leaves[name] = {"sh": list(arr.shape), "dt": str(arr.dtype),
                        "v": masked[name].astype(spec.wire_dtype)}
    return {SECURE_QUANT_KEY: SQ_VERSION, "p": int(spec.p),
            "fb": int(spec.frac_bits), "k": int(spec.n_shares),
            "seeds": seeds, "leaves": leaves}


def _validate_frame(frame: dict, spec: QuantSpec) -> None:
    if not is_secure_quant_frame(frame):
        raise ValueError(
            "expected a secure-quant field-element frame; got a "
            f"{type(frame).__name__} without the frame magic — the sender "
            "is not running --secure_quant (config skew)")
    ver = int(frame[SECURE_QUANT_KEY])
    if ver != SQ_VERSION:
        raise ValueError(f"secure-quant frame version {ver} != supported "
                         f"{SQ_VERSION}")
    got = (int(frame["p"]), int(frame["fb"]), int(frame["k"]))
    want = (spec.p, spec.frac_bits, spec.n_shares)
    if got != want:
        raise ValueError(
            f"secure-quant spec mismatch: frame carries (p, frac_bits, "
            f"n_shares) = {got}, server configured {want} — every rank "
            "must share one --secure_quant_field_bits / "
            "--secure_quant_frac_bits / --mpc_n_shares configuration")
    n_seeds = int(np.asarray(frame["seeds"]).size)
    if n_seeds != spec.n_shares - 1:
        raise ValueError(
            f"secure-quant frame carries {n_seeds} mask seeds, expected "
            f"n_shares - 1 = {spec.n_shares - 1}")


# ---------------------------------------------------------------------------
# the server's fold
# ---------------------------------------------------------------------------

class SlotAccumulator:
    """Slot-major GF(p) accumulation of arriving frames, the secure
    server's only model-sized state: slot j of every client folds into
    accumulator j, and the accumulators combine only in ``finalize`` (no
    stored intermediate equals a client's quantized update). ``trace``
    (for tests) receives every accumulator after every fold."""

    def __init__(self, spec: QuantSpec, trace: list | None = None,
                 like: Tree | None = None):
        self.spec = spec
        self.trace = trace
        self._slots: list[dict[str, np.ndarray]] | None = None
        #: the expected (leaf name, size) structure: ``like``'s, else the
        #: first folded frame's; a later frame must match it before any
        #: accumulator changes
        self._sizes: list[tuple[str, int]] | None = None
        if like is not None:
            self._sizes = [(name, int(np.asarray(x).size))
                           for name, x in _named_leaves(like)]
        self.folded = 0

    @staticmethod
    def _frame_sizes(frame: dict) -> list[tuple[str, int]]:
        return [(name, int(np.prod(rec["sh"])) if rec["sh"] else 1)
                for name, rec in frame["leaves"].items()]

    def _expand(self, frame: dict) -> list[dict[str, np.ndarray]]:
        sizes = self._frame_sizes(frame)
        slots = [_mask_slot(int(s), sizes, self.spec.p)
                 for s in np.asarray(frame["seeds"]).tolist()]
        slots.append({name: np.asarray(rec["v"], np.int64)
                      for name, rec in frame["leaves"].items()})
        return slots

    def fold(self, frame: dict, weight_int: int = 1) -> None:
        """Fold one client's frame whole or not at all: its spec and leaf
        structure are checked before any accumulator changes, so a skewed
        frame raises with the accumulators untouched. ``weight_int``
        scales every slot inside the field: 1 where the client applied its
        weight, the integer fold weight on the one-phase path."""
        _validate_frame(frame, self.spec)
        w = int(weight_int)
        if w < 1:
            raise ValueError(f"weight_int must be >= 1, got {w}")
        sizes = self._frame_sizes(frame)
        if self._sizes is None:
            self._sizes = sizes
        elif sizes != self._sizes:
            raise ValueError(
                "secure-quant frame leaf structure mismatch: frame "
                f"carries {sizes[:3]}... vs expected {self._sizes[:3]}"
                "... — sender and receiver model trees differ (version "
                "skew); frame discarded whole")
        slots = self._expand(frame)
        if self._slots is None:
            self._slots = [
                {name: (w * v) % self.spec.p for name, v in s.items()}
                for s in slots]
        else:
            for acc, s in zip(self._slots, slots):
                for name, v in s.items():
                    # w * v stays below 2^62: check_headroom bounds it
                    acc[name] = (acc[name] + w * v) % self.spec.p
        self.folded += 1
        self._record()

    def _record(self) -> None:
        if self.trace is not None:
            self.trace.extend(np.concatenate(
                [a.reshape(-1) for a in s.values()]).copy()
                for s in self._slots)

    def merge(self, other: "SlotAccumulator") -> None:
        """Fold another accumulator into this one, slot by slot, mod p. The
        residue algebra is commutative and associative, so merging
        accumulators in any order equals folding every frame into one (the
        sharded ingest plane's invariant). Both must share the spec and
        leaf structure; ``other`` is left as it is."""
        if other.spec != self.spec:
            raise ValueError(
                f"cannot merge SlotAccumulators with different specs: "
                f"{other.spec} vs {self.spec}")
        if other._slots is None:
            return
        if self._sizes is not None and other._sizes != self._sizes:
            raise ValueError(
                "secure-quant accumulator merge: leaf structure "
                f"mismatch ({other._sizes[:3]}... vs "
                f"{self._sizes[:3]}...)")
        if self._slots is None:
            self._sizes = other._sizes
            self._slots = [{name: v.copy() for name, v in s.items()}
                           for s in other._slots]
        else:
            for acc, s in zip(self._slots, other._slots):
                for name, v in s.items():
                    acc[name] = (acc[name] + v) % self.spec.p
        self.folded += other.folded
        self._record()

    def _total(self) -> dict[str, np.ndarray]:
        total = self._slots[0]
        for s in self._slots[1:]:
            total = {name: (total[name] + s[name]) % self.spec.p
                     for name in total}
        return total

    def export_centered(self) -> dict[str, np.ndarray] | None:
        """The slots combined and centre-lifted into plain int64 (``t - p``
        above ``p // 2``). While the weighted aggregate lies in the field's
        centred range, the lift is the true integer ``sum_c w_c * q_c`` of
        this accumulator's frames, so lifted partials of several processes
        add exactly in int64 with no shared modulus. None when nothing was
        folded; the accumulator is kept."""
        if self._slots is None:
            return None
        half = self.spec.p // 2
        return {name: np.where(t > half, t - self.spec.p, t)
                for name, t in self._total().items()}

    def finalize(self, like: Tree, rescale: float = 1.0,
                 scales: dict[str, float] | None = None) -> Tree:
        """The slots combined, dequantized (the float32 centred lift, bit
        for bit the device's), the ``leaf_scales`` undone, times
        ``rescale`` (1 / W for the survivors' weight mass), shaped and
        typed like ``like``. Resets the accumulator."""
        if self._slots is None:
            raise ValueError("finalize() before any frame folded")
        out = {}
        for name, t in self._total().items():
            deq = mpc.dequantize32(t, p=self.spec.p,
                                   frac_bits=self.spec.frac_bits)
            if scales:
                deq = deq * np.float32(scales[name])
            out[name] = np.asarray(rescale * deq, np.float64)
        self._slots = None
        self.folded = 0
        rebuilt = {}
        for name, x in _named_leaves(like):
            arr = np.asarray(x)
            rebuilt[name] = out[name].reshape(arr.shape).astype(arr.dtype)
        return _rebuild_like(like, rebuilt)


# ---------------------------------------------------------------------------
# the plain reference and helpers
# ---------------------------------------------------------------------------

def quantized_weighted_mean(trees: list, weights, spec: QuantSpec,
                            rescale: float = 1.0,
                            scales: dict[str, float] | None = None) -> Tree:
    """The plain, mask-free quantized weighted mean
    ``dequantize(sum_c quantize(w_c * u_c))`` over normalized weights, in
    the same float32 embedding and scales: what the secure fold must equal
    bit for bit over the same clients."""
    w = np.asarray(weights, np.float64)
    wn = w / max(float(np.sum(w)), 1e-12)
    acc: dict[str, np.ndarray] | None = None
    for tree, wc in zip(trees, wn):
        q = {name: mpc.quantize32(
            np.float32(wc) * np.asarray(x, np.float32).reshape(-1)
            / np.float32(scales[name] if scales else 1.0),
            p=spec.p, frac_bits=spec.frac_bits)
            for name, x in _named_leaves(tree)}
        acc = q if acc is None else {
            name: (acc[name] + q[name]) % spec.p for name in acc}
    out = {}
    for name, x in _named_leaves(trees[0]):
        arr = np.asarray(x)
        deq = mpc.dequantize32(acc[name] % spec.p, p=spec.p,
                               frac_bits=spec.frac_bits)
        if scales:
            deq = deq * np.float32(scales[name])
        out[name] = np.asarray(rescale * deq, np.float64).reshape(
            arr.shape).astype(arr.dtype)
    return _rebuild_like(trees[0], out)


def weighted_fold_capacity(spec: QuantSpec,
                           value_bound: float = VALUE_BOUND) -> float:
    """The integer weight mass one aggregation can fold before the
    weighted aggregate leaves the field's centred range (a 16-bit field
    folds about 2 weight units; the one-phase path needs field_bits
    32)."""
    return (spec.p // 2) / (value_bound * (1 << spec.frac_bits))


def integer_weights(weights, spec: QuantSpec,
                    value_bound: float = VALUE_BOUND
                    ) -> tuple[np.ndarray, float]:
    """Integer fold weights for the one-phase path: the weights over their
    max, times the largest ``2^s, s <= WEIGHT_FRAC_BITS`` whose total stays
    inside ``weighted_fold_capacity``, rounded, at least 1 (an admitted
    upload never folds at 0). Only ratios matter: the dequantized total is
    divided by the integer mass. Returns ``(w_int[C], denom)``, the
    weighted mean being the dequantized total over ``denom``."""
    from neuroimagedisttraining_tpu_torch.privacy.accountant import (
        validate_weights,
    )

    w = validate_weights(weights)
    wn = w / float(np.max(w))
    limit = weighted_fold_capacity(spec, value_bound)
    for s in range(WEIGHT_FRAC_BITS, -1, -1):
        wi = np.maximum(np.rint(wn * (1 << s)).astype(np.int64), 1)
        if float(np.sum(wi)) < limit:
            return wi, float(np.sum(wi))
    raise ValueError(
        f"secure_quant weighted-fold headroom exhausted: {w.size} "
        f"buffered uploads cannot fold inside p={spec.p} at "
        f"frac_bits={spec.frac_bits} (capacity {limit:.1f} weight "
        "units) — use --secure_quant_field_bits 32 for the buffered "
        "one-phase path, or shrink --buffer_k")


def frame_nbytes(frame: dict) -> int:
    """A frame's bytes on the wire once the message envelope serializes
    it."""
    from neuroimagedisttraining_tpu_torch.codec import wire

    return wire.frame_nbytes(frame)
