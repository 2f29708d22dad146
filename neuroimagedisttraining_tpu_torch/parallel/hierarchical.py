"""Two-level (silo, then global) aggregation over a ``(silos, clients)``
mesh (the reference package's ``parallel/hierarchical.py``).

The clients of a round are cut into the mesh's entries in row-major
order, each silo a row of entries. Each entry sums its clients weighted
by their sample counts; a silo adds its entries' sums (and weights) in
entry order; the silos' sums are then added in silo order and divided by
the total weight once. ``norm_bound`` clips each silo's mean to within
``norm_bound`` of the previous global model before the cross-silo mean:
norm-difference clipping with a silo as the unit. Without the clip the
result is the flat weighted mean up to the order of the float sums.
"""

from __future__ import annotations

import torch

from neuroimagedisttraining_tpu_torch.core.robust import norm_diff_clip
from neuroimagedisttraining_tpu_torch.parallel.mesh import (
    SILO_AXIS, Mesh, make_mesh,
)


def make_two_level_mesh(num_silos: int, clients_per_silo: int,
                        devices=None) -> Mesh:
    """The 2-D ``(silos, clients)`` mesh."""
    return make_mesh(devices=devices, shape=(num_silos, clients_per_silo))


def is_two_level(mesh: Mesh | None) -> bool:
    return mesh is not None and SILO_AXIS in mesh.axis_names


def silo_then_global_mean(stacked: list[dict], weights: torch.Tensor,
                          mesh: Mesh, global_params: dict | None = None,
                          norm_bound: float | None = None) -> dict:
    """The weighted mean of the clients' states ``stacked`` (a list of
    dicts, one a client, the list a multiple of the mesh size) by
    ``weights`` ``[C]``, silo by silo and then across silos, each leaf in
    its input dtype."""
    S, Cps = mesh.shape
    D = S * Cps
    C = len(stacked)
    if C % D:
        raise ValueError(f"silo_then_global_mean: {C} clients do not tile "
                         f"the {mesh.shape} mesh")
    if not stacked or not stacked[0]:
        return stacked[0] if stacked else {}
    B = C // D
    w = weights.to(torch.float32)
    keys = list(stacked[0])
    gsum, gtot = None, None
    for s in range(S):
        wsum, wtot = None, None
        for e in range(s * Cps, (s + 1) * Cps):
            lo, hi = e * B, (e + 1) * B
            wb = w[lo:hi]
            part = {k: torch.tensordot(
                wb, torch.stack([st[k] for st in stacked[lo:hi]]
                                ).to(torch.float32), dims=([0], [0]))
                for k in keys}
            t = torch.sum(wb)
            wsum = part if wsum is None else {k: wsum[k] + part[k]
                                              for k in keys}
            wtot = t if wtot is None else wtot + t
        if norm_bound is not None:
            if global_params is None:
                raise ValueError("clipping needs global_params")
            silo_mean = {k: v / torch.clamp(wtot, min=1e-9)
                         for k, v in wsum.items()}
            clipped = norm_diff_clip(silo_mean, global_params, norm_bound)
            wsum = {k: clipped[k] * wtot for k in keys}
        gsum = wsum if gsum is None else {k: gsum[k] + wsum[k] for k in keys}
        gtot = wtot if gtot is None else gtot + wtot
    return {k: (gsum[k] / torch.clamp(gtot, min=1e-9)).to(stacked[0][k].dtype)
            for k in keys}
