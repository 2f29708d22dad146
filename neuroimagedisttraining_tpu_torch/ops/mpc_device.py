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

``secure_quant_fold`` is the engines' ``--secure_quant`` tail: the
one-phase GF(p) fold of secure quantized aggregation
(``privacy/secure_quant.py``) with integer client weights, bit for bit
what the host protocol's ``SlotAccumulator`` gives over the clients'
masked frames (the masks cancel mod p, so the fold needs none).
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


def sq_integer_weights(w: torch.Tensor, shift: int) -> torch.Tensor:
    """The integer fold weights ``max(rint(w / max(w) * 2^shift), 1)`` as
    float32. Each operation is one correctly rounded float32 operation (or
    exact), so the same numpy formula over the same float32 weights gives
    the same integers."""
    w = w.to(torch.float32)
    wn = w / torch.max(w)
    return torch.clamp(torch.round(wn * float(1 << shift)), min=1.0)


def secure_quant_fold(uploads: list[dict[str, torch.Tensor]],
                      w: torch.Tensor, p: int, frac_bits: int, shift: int,
                      scales: dict[str, float]) -> dict[str, torch.Tensor]:
    """The weighted mean of the clients' ``uploads`` through the field: a
    leaf over its power-of-two scale, quantized (``quantize_device``; a
    NaN to the zero residue), times the client's integer weight
    (:func:`sq_integer_weights` of ``w``) mod p, summed over the clients
    mod p, the centred lift over ``2^frac_bits``, times the scale, over
    the integer mass, in the leaf's dtype. The products ``wi * q`` stay
    below 2^7 * 2^31, exact in int64. No host sync."""
    wi = sq_integer_weights(w, shift)
    denom = torch.sum(wi)  # an integer well inside float32's exact range
    wq = wi.to(torch.int64)
    out = {}
    for k, v in uploads[0].items():
        x = torch.stack([u[k] for u in uploads]).to(torch.float32)
        s = float(scales.get(k, 1.0))
        q = quantize_device(x / s, p=p, frac_bits=frac_bits)
        q = q * wq.reshape((-1,) + (1,) * (q.dim() - 1)) % p
        total = torch.sum(q, dim=0) % p
        deq = dequantize_device(total, p=p, frac_bits=frac_bits) * s
        out[k] = (deq / denom).to(v.dtype)
    return out
