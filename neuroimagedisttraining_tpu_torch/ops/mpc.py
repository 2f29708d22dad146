"""The finite-field MPC toolkit on the host (numpy): Shamir/BGW and
Lagrange Coded Computing shares, Lagrange coefficients, additive secret
shares and TurboAggregate's ``secure_sum``, Diffie-Hellman-style key
agreement, and the fixed-point embeddings of floats into GF(p). It is what
TurboAggregate's ``mpc_backend="host"`` runs, the reference for
``ops/mpc_device.py``, and the field algebra of secure quantized
aggregation (``privacy/secure_quant.py``).

Every operation is a vectorized numpy expression over int64 with a modulus
after each product, so every intermediate stays below 2^63 for any prime
p < 2^31.5 (the default p = 2^31 - 1, a Mersenne prime). Modular inverses
are Fermat's, ``a^(p-2) mod p`` by square-and-multiply.

A client's weighted update is quantized to fixed point
(``round(x * 2^frac_bits) mod p``, float64 in ``quantize``; float32 with a
sign-preserving clamp at the field edge in ``quantize32``, bit for bit the
device's), split into ``n_shares`` additive shares that sum to it mod p,
and the server adds each share SLOT over every client before it combines
any two slots: every intermediate it holds is uniformly random masked
material, and only the final sum of the slots, the aggregate itself, is in
the clear. The sum of the shares mod p equals the sum of the quantized
updates mod p, so the aggregate does not depend on the masks drawn.
"""

from __future__ import annotations

import numpy as np

P_DEFAULT = 2**31 - 1  # a Mersenne prime; p^2 < 2^63 keeps int64 exact

#: the fields of secure quantized aggregation, by wire width: the largest
#: prime below 2^bits (a smaller field ships fewer bytes a residue)
FIELD_PRIMES = {8: 251, 16: 65521, 32: P_DEFAULT}


def wire_dtype_for(p: int) -> np.dtype:
    """The smallest unsigned dtype that holds every residue of GF(p): what
    a field-element frame ships a masked value in."""
    if p <= 1 << 8:
        return np.dtype(np.uint8)
    if p <= 1 << 16:
        return np.dtype(np.uint16)
    if p < 1 << 32:
        return np.dtype(np.uint32)
    raise ValueError(f"field modulus {p} exceeds the uint32 wire width")


def _asfield(x, p: int) -> np.ndarray:
    return np.mod(np.asarray(x, np.int64), p)


def mod_pow(base, exp: int, p: int) -> np.ndarray:
    """``base ** exp mod p`` over int64 arrays, by square-and-multiply."""
    base = _asfield(base, p)
    out = np.ones_like(base)
    e = int(exp)
    while e > 0:
        if e & 1:
            out = (out * base) % p
        base = (base * base) % p
        e >>= 1
    return out


def mod_inv(a, p: int) -> np.ndarray:
    """Fermat's inverse ``a^(p-2) mod p`` (p prime) of every unit."""
    return mod_pow(a, p - 2, p)


def lagrange_coeffs(alphas, betas, p: int) -> np.ndarray:
    """``U[i, j] = prod_{k != j} (alpha_i - beta_k) / (beta_j - beta_k)``
    mod p: the Lagrange basis over the points ``betas`` evaluated at the
    targets ``alphas``."""
    alphas = _asfield(alphas, p)
    betas = _asfield(betas, p)
    A, B = len(alphas), len(betas)
    den = np.ones(B, np.int64)
    num = np.ones((A, B), np.int64)
    for k in range(B):
        db = np.mod(betas - betas[k], p)            # [B]
        db[k] = 1                                   # no self term
        den = (den * db) % p
        da = np.mod(alphas[:, None] - betas[k], p)  # [A, 1]
        keep = np.ones(B, np.int64)
        keep[k] = 0                                 # excluded for j == k
        num = (num * np.where(keep, da, 1)) % p
    return (num * mod_inv(den, p)[None, :]) % p


# ---------------- BGW (Shamir) secret sharing ----------------

def bgw_encode(X, N: int, T: int, p: int = P_DEFAULT, rng=None) -> np.ndarray:
    """Degree-``T`` Shamir shares of the field elements ``X`` (any shape)
    at alpha = 1..N: ``[N, *X.shape]``. Any ``T`` shares reveal nothing;
    ``T + 1`` reconstruct."""
    rng = rng or np.random.default_rng()  # nidt: allow[determinism-unseeded-rng] -- secret-sharing masks MUST be unpredictable: fresh OS entropy unless a test injects rng
    X = _asfield(X, p)
    coeffs = np.concatenate(
        [X[None], rng.integers(0, p, size=(T,) + X.shape, dtype=np.int64)])
    alphas = np.arange(1, N + 1, dtype=np.int64) % p
    shares = np.zeros((N,) + X.shape, np.int64)
    a_pow = np.ones(N, np.int64)
    for t in range(T + 1):
        term = (a_pow.reshape((N,) + (1,) * X.ndim) * coeffs[t]) % p
        shares = (shares + term) % p
        a_pow = (a_pow * alphas) % p
    return shares


def bgw_decode(shares, worker_idx, p: int = P_DEFAULT) -> np.ndarray:
    """The secret from at least ``T + 1`` shares ``[R, ...]`` of the
    0-based workers ``worker_idx``: the share polynomial interpolated at
    0."""
    alphas_eval = (np.asarray(worker_idx, np.int64) + 1) % p
    lam = lagrange_coeffs(np.zeros(1, np.int64), alphas_eval, p)[0]  # [R]
    acc = np.zeros(shares.shape[1:], np.int64)
    for r in range(shares.shape[0]):
        acc = (acc + lam[r] * _asfield(shares[r], p)) % p
    return acc


# ---------------- LCC (Lagrange Coded Computing) ----------------

def _lcc_points(N: int, K: int, T: int, p: int):
    """The evaluation (alphas) and interpolation (betas) points. The
    original code centres both grids around 0, so they overlap, and a
    worker whose alpha equals a data chunk's beta receives that chunk in
    the clear. Here the alphas start after the last beta: the grids are
    disjoint, and encode and decode stay consistent."""
    n_beta = K + T
    stt_b = -(n_beta // 2)
    betas = np.arange(stt_b, stt_b + n_beta, dtype=np.int64)
    alphas = np.arange(betas[-1] + 1, betas[-1] + 1 + N, dtype=np.int64)
    return np.mod(alphas, p), np.mod(betas, p)


def lcc_encode(X, N: int, K: int, T: int, p: int = P_DEFAULT,
               rng=None) -> np.ndarray:
    """``X`` (first axis divisible by ``K``) split into ``K`` chunks plus
    ``T`` random ones, interpolated through them at the betas and
    evaluated at the alphas: ``[N, m // K, ...]``."""
    rng = rng or np.random.default_rng()  # nidt: allow[determinism-unseeded-rng] -- secret-sharing masks MUST be unpredictable: fresh OS entropy unless a test injects rng
    X = _asfield(X, p)
    m = X.shape[0]
    assert m % K == 0, f"first axis {m} not divisible by K={K}"
    chunks = X.reshape((K, m // K) + X.shape[1:])
    if T:
        rand = rng.integers(0, p, size=(T,) + chunks.shape[1:],
                            dtype=np.int64)
        chunks = np.concatenate([chunks, rand])
    alphas, betas = _lcc_points(N, K, T, p)
    U = lagrange_coeffs(alphas, betas, p)          # [N, K + T]
    out = np.zeros((N,) + chunks.shape[1:], np.int64)
    for j in range(K + T):
        term = (U[:, j].reshape((N,) + (1,) * (chunks.ndim - 1))
                * chunks[j]) % p
        out = (out + term) % p
    return out


def lcc_decode(f_eval, N: int, K: int, T: int, worker_idx,
               p: int = P_DEFAULT) -> np.ndarray:
    """The ``K`` data chunks, concatenated, from the workers' evaluations
    ``f_eval[R, m // K, ...]``."""
    alphas, betas = _lcc_points(N, K, T, p)
    alphas_eval = alphas[np.asarray(worker_idx, np.int64)]
    U = lagrange_coeffs(betas[:K], alphas_eval, p)  # [K, R]
    out = np.zeros((K,) + f_eval.shape[1:], np.int64)
    for r in range(f_eval.shape[0]):
        term = (U[:, r].reshape((K,) + (1,) * (f_eval.ndim - 1))
                * _asfield(f_eval[r], p)) % p
        out = (out + term) % p
    return out.reshape((K * f_eval.shape[1],) + f_eval.shape[2:])


# ---------------- DH key agreement ----------------

def pk_gen(sk: int, p: int = P_DEFAULT, g: int = 0) -> int:
    """The public key ``g^sk mod p``; ``g = 0`` is the original code's
    test mode, which returns ``sk``."""
    return int(sk) if g == 0 else int(mod_pow(np.int64(g), int(sk), p))


def key_agreement(my_sk: int, u_pk: int, p: int = P_DEFAULT,
                  g: int = 0) -> int:
    """The shared key ``u_pk^my_sk mod p`` (``my_sk * u_pk mod p`` in the
    ``g = 0`` test mode)."""
    return (int(np.mod(np.int64(my_sk) * np.int64(u_pk), p)) if g == 0
            else int(mod_pow(np.int64(u_pk), int(my_sk), p)))


# ---------------- fixed-point float <-> field ----------------

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


def quantize32(x, p: int = P_DEFAULT, frac_bits: int = 16) -> np.ndarray:
    """The float32 embedding, bit for bit ``ops/mpc_device.py``
    ``quantize_device``: float32 scaling, rounding half to even, NaN to the
    zero residue, and a sign-preserving clamp at the field edge (the
    largest float32 at most (p - 1) / 2) for what overflows, +/-inf
    included. The float64 ``quantize`` can differ by one unit in the last
    fixed-point place; secure quantized aggregation needs the host and the
    device to agree exactly."""
    lim = np.float32((p - 1) // 2)
    if int(lim) > (p - 1) // 2:  # float32 rounded up past the field edge
        lim = np.nextafter(lim, np.float32(0.0))
    scaled = np.rint(np.asarray(x, np.float32) * np.float32(1 << frac_bits))
    # NaN would pass the clip and cast to INT_MIN, an out-of-field residue
    scaled = np.where(np.isnan(scaled), np.float32(0.0), scaled)
    v = np.clip(scaled, -lim, lim).astype(np.int32).astype(np.int64)
    return np.where(v < 0, v + p, v)


def dequantize32(q, p: int = P_DEFAULT, frac_bits: int = 16) -> np.ndarray:
    """The centred lift over ``2^frac_bits`` in float32, bit for bit
    ``dequantize_device``."""
    q = _asfield(q, p)
    centered = np.where(q > p // 2, q - p, q).astype(np.int32)
    return centered.astype(np.float32) / np.float32(1 << frac_bits)


# ---------------- additive secret sharing ----------------

def additive_shares(x, n_out: int, p: int = P_DEFAULT,
                    rng=None) -> np.ndarray:
    """``[n_out, ...]`` shares summing to ``x`` mod p: ``n_out - 1``
    uniform draws and the remainder."""
    rng = rng or np.random.default_rng()  # nidt: allow[determinism-unseeded-rng] -- secret-sharing masks MUST be unpredictable: fresh OS entropy unless a test injects rng
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
    rng = rng or np.random.default_rng()  # nidt: allow[determinism-unseeded-rng] -- secret-sharing masks MUST be unpredictable: fresh OS entropy unless a test injects rng
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
