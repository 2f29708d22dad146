"""Additive secret sharing over GF(p) on the host (numpy): what
TurboAggregate's ``mpc_backend="host"`` runs, and the reference for
``ops/mpc_device.py``.

A client's weighted update is quantized to fixed point
(``round(x * 2^frac_bits) mod p``, float64 on the host), split into
``n_shares`` additive shares that sum to it mod p, and the server adds
each share SLOT over every client before it combines any two slots: every
intermediate it holds is uniformly random masked material, and only the
final sum of the slots, the aggregate itself, is in the clear. The sum of
the shares mod p equals the sum of the quantized updates mod p, so the
aggregate does not depend on the masks drawn.
"""

from __future__ import annotations

import numpy as np

P_DEFAULT = 2**31 - 1  # a Mersenne prime; p^2 < 2^63 keeps int64 exact


def _asfield(x, p: int) -> np.ndarray:
    return np.mod(np.asarray(x, np.int64), p)


def quantize(x, p: int = P_DEFAULT, frac_bits: int = 16) -> np.ndarray:
    """``round(x * 2^frac_bits) mod p`` (float64, half to even); exact for
    ``|x| * 2^frac_bits < p / 2``."""
    scaled = np.rint(np.asarray(x, np.float64) * (1 << frac_bits))
    return np.mod(scaled.astype(np.int64), p)


def dequantize(q, p: int = P_DEFAULT, frac_bits: int = 16) -> np.ndarray:
    """The centred lift of residues ``q`` (above p / 2 is negative) over
    ``2^frac_bits``, in float64."""
    q = _asfield(q, p)
    centered = np.where(q > p // 2, q - p, q)
    return centered.astype(np.float64) / (1 << frac_bits)


def additive_shares(x, n_out: int, p: int = P_DEFAULT,
                    rng=None) -> np.ndarray:
    """``[n_out, ...]`` shares summing to ``x`` mod p: ``n_out - 1``
    uniform draws and the remainder."""
    rng = rng or np.random.default_rng()  # masks must be unpredictable
    x = _asfield(x, p)
    shares = rng.integers(0, p, size=(n_out - 1,) + x.shape, dtype=np.int64)
    last = np.mod(x - np.mod(shares.sum(axis=0), p), p)
    return np.concatenate([shares, last[None]])


def secure_sum(stack, n_shares: int, frac_bits: int = 16,
               p: int = P_DEFAULT, rng=None, trace=None) -> np.ndarray:
    """The sum over clients of ``stack[S, ...]`` by additive shares: each
    client's quantized update split into ``n_shares`` shares, slot ``j``
    summed over every client (in client order) before the slots are
    combined, then dequantized (float64). ``trace``: a list that receives
    every slot accumulator after every client (the server's
    intermediates)."""
    rng = rng or np.random.default_rng()  # masks must be unpredictable
    stack = np.asarray(stack)
    slots = np.zeros((n_shares,) + stack.shape[1:], np.int64)
    for c in range(stack.shape[0]):
        q = quantize(stack[c], p=p, frac_bits=frac_bits)
        shares = additive_shares(q, n_shares, p=p, rng=rng)
        slots = (slots + shares) % p
        if trace is not None:
            trace.extend(slots.copy())
    total = np.mod(slots.sum(axis=0), p)
    return dequantize(total, p=p, frac_bits=frac_bits)
