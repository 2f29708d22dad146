"""Additive secret sharing over GF(p) on the device: TurboAggregate's share
stage (``mpc_backend="device"``) as torch operations, with no host
round trip.

The same pipeline as ``ops/mpc.py`` ``secure_sum``: quantize each
client's update into GF(p), split it into ``n_shares`` additive shares,
add each share slot over every client (ascending client order) before any
two slots combine, then combine the slots and dequantize. Residues ride in
int64 (torch's unsigned arithmetic is limited): every residue is below
p = 2^31 - 1, so the sum of two never overflows, and each addition is
reduced mod p at once. Quantization is float32 on the device (the host's
is float64, so the two can differ by one unit in the last fixed-point
place of an element).

The masks are uniform draws in [0, p) from an explicit
``torch.Generator``; they cancel exactly in the slot sum, so the aggregate
does not depend on them. This is plain PyTorch: the reference computes
the stage in plain XLA, with no Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.ops.mpc import P_DEFAULT


def _field_edge(p: int) -> float:
    """The largest float32 at most (p - 1) / 2: float32((p - 1) // 2)
    rounds up past it for p = 2^31 - 1, so it is stepped down."""
    lim = np.float32((p - 1) // 2)
    if int(lim) > (p - 1) // 2:
        lim = np.nextafter(lim, np.float32(0.0))
    return float(lim)


def quantize_device(x: torch.Tensor, p: int = P_DEFAULT,
                    frac_bits: int = 16) -> torch.Tensor:
    """``round(x * 2^frac_bits) mod p`` as int64 residues: float32 scaling,
    rounding half to even, NaN to 0, and a sign-preserving clamp at the
    field edge (the largest float32 below p / 2) for what overflows."""
    scaled = torch.round(x.to(torch.float32) * (1 << frac_bits))
    scaled = torch.where(torch.isnan(scaled), torch.zeros_like(scaled),
                         scaled)
    lim = _field_edge(p)
    v = torch.clamp(scaled, -lim, lim).to(torch.int64)
    return torch.where(v < 0, v + p, v)


def dequantize_device(q: torch.Tensor, p: int = P_DEFAULT,
                      frac_bits: int = 16) -> torch.Tensor:
    """The centred lift of residues ``q`` over ``2^frac_bits``, float32."""
    centered = torch.where(q > p // 2, q - p, q)
    return centered.to(torch.float32) / (1 << frac_bits)


def _addmod(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    s = a + b  # both below p < 2^31: no overflow in int64
    return torch.where(s >= p, s - p, s)


def secure_sum_device(stack: torch.Tensor, generator: torch.Generator,
                      n_shares: int, frac_bits: int = 16, p: int = P_DEFAULT,
                      return_slots: bool = False):
    """The sum over clients of ``stack[S, ...]`` by additive shares on the
    device (float32). With ``return_slots`` the slot totals (the server's
    only intermediates) ``[n_shares, ...]`` are returned too."""
    if n_shares < 2:
        raise ValueError(f"secure_sum_device needs n_shares >= 2 "
                         f"({n_shares} given): one share is the plaintext")
    if not 1 < p < 1 << 31:
        raise ValueError(f"field modulus p must be in (1, 2^31), got {p}")
    S = stack.shape[0]
    q = quantize_device(stack, p=p, frac_bits=frac_bits)       # [S, ...]
    r = torch.randint(0, p, (n_shares - 1,) + tuple(q.shape),
                      generator=generator, device=q.device,
                      dtype=torch.int64)
    rsum = r[0]
    for j in range(1, n_shares - 1):
        rsum = _addmod(rsum, r[j], p)
    last = _addmod(q, p - rsum, p)                             # q - rsum
    shares = torch.cat([r, last[None]])                # [n_shares, S, ...]
    del r, rsum, last, q
    slots = shares[:, 0]
    for c in range(1, S):
        slots = _addmod(slots, shares[:, c], p)
    total = slots[0]
    for j in range(1, n_shares):
        total = _addmod(total, slots[j], p)
    out = dequantize_device(total, p=p, frac_bits=frac_bits)
    return (out, slots) if return_slots else out


def secure_aggregate_tree(weighted: dict[str, torch.Tensor],
                          generator: torch.Generator, n_shares: int,
                          frac_bits: int = 16, p: int = P_DEFAULT
                          ) -> dict[str, torch.Tensor]:
    """:func:`secure_sum_device` over every leaf of a client-stacked state
    ``{name: [S, ...]}``, one leaf at a time (the int64 shares of one leaf
    are held at once, never the whole model's)."""
    return {k: secure_sum_device(v, generator, n_shares, frac_bits=frac_bits,
                                 p=p) for k, v in weighted.items()}
