"""Byzantine value faults (the ``byz:`` grammar), the reference package's
``faults/adversary.py`` over the port's uploads.

``faults/schedule.py`` decides who is Byzantine when, and with which
kind; this module applies the kind to a client's upload, against the
round's broadcast reference (the model the client just received)::

    sign_flip   u' = ref - (u - ref)            (flip the update delta)
    scale:K     u' = ref + K (u - ref)          (amplified update)
    gauss:STD   u' = ref + (u - ref) + STD n    (n standard normal)
    nonfinite   u' = NaN everywhere             (poison-the-mean probe)

All kinds are one form, ``u' = ref + mult (u - ref) + std n`` with NaN
where ``nonfinite``, so a round's attack is three numbers per client
(``plan_arrays``). An upload is a state dict (the parameters and the
BatchNorm statistics together: the attack hits what the wire ships). An
honest client's upload is returned as it is, bit for bit: nothing is
recomputed for it. The Gaussian draws ``n`` are inputs: the engines draw
them from generators keyed by (seed, round, rank, leaf).
"""

from __future__ import annotations

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.faults.schedule import FaultSchedule

State = dict[str, torch.Tensor]


def kind_params(kind: str | None) -> tuple[float, float, bool]:
    """``(mult, std, nonfinite)`` of a canonical kind string
    (``schedule.parse_byz_kind``) or None (an honest client)."""
    if kind is None:
        return 1.0, 0.0, False
    name, _, param = kind.partition(":")
    if name == "sign_flip":
        return -1.0, 0.0, False
    if name == "scale":
        return float(param), 0.0, False
    if name == "gauss":
        return 1.0, float(param), False
    if name == "nonfinite":
        return 1.0, 0.0, True
    raise ValueError(f"unknown byz kind {kind!r}")


def plan_arrays(schedule: FaultSchedule, round_idx: int,
                ranks) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The round's attack plan over cross-silo ``ranks``: ``(mult[C],
    std[C], nonfinite[C])`` (an honest client gets 1 / 0 / False)."""
    mult, std, nan = [], [], []
    for r in np.asarray(ranks):
        m, s, n = kind_params(schedule.byzantine_kind(round_idx, int(r)))
        mult.append(m)
        std.append(s)
        nan.append(n)
    return (np.asarray(mult, np.float32), np.asarray(std, np.float32),
            np.asarray(nan, bool))


def is_honest(mult: float, std: float, nonfinite: bool) -> bool:
    return float(mult) == 1.0 and float(std) == 0.0 and not nonfinite


def apply_attack(update: State, reference: State, mult: float, std: float,
                 nonfinite: bool, noise: State | None = None) -> State:
    """One client's attacked upload. ``noise``: standard normal draws
    shaped like each leaf (needed when ``std != 0``). An honest plan
    returns ``update`` itself."""
    if is_honest(mult, std, nonfinite):
        return update
    out = {}
    for k, u in update.items():
        if nonfinite:
            out[k] = torch.full_like(u, float("nan"))
            continue
        u32, r32 = u.float(), reference[k].float()
        m = torch.tensor(float(mult), dtype=torch.float32, device=u.device)
        y = r32 + (u32 - r32) * m
        if float(std) != 0.0:
            s = torch.tensor(float(std), dtype=torch.float32,
                             device=u.device)
            y = y + s * noise[k]
        out[k] = y.to(u.dtype)
    return out


def apply_attack_stacked(updates: list[State], reference: State, mult,
                         std, nonfinite, noises=None) -> list[State]:
    """``apply_attack`` over a cohort's uploads; ``noises`` a list of each
    client's draws (entries may be None for clients without ``std``)."""
    return [apply_attack(u, reference, float(mult[c]), float(std[c]),
                         bool(nonfinite[c]),
                         noises[c] if noises is not None else None)
            for c, u in enumerate(updates)]
