"""The autotuner's search space as data (the reference package's
``tune/space.py``).

A space is the cross product of the probe cell axes (obs/probe.py
``CELL_KEYS`` — the ``batch`` axis included) filtered through validity
predicates, so the search NEVER proposes a cell the CLIs would reject
at startup:

- every axis value passes the probe domain check
  (``obs_probe.validate_cell_value`` — the same validator manifests
  load through);
- the startup-rejection knowledge extracted into
  ``analysis/compat_matrix.py`` is re-applied here: of the committed
  rejection rows, exactly those whose guard knobs fall inside the
  tuned-or-pinned knob set constrain the space
  (``relevant_compat_rows``), and the predicates satisfy each one —
  ``fused_update`` composes because the tuner PINS
  ``client_optimizer=sgd``; ``loss_scale`` is pinned 1.0 so every
  precision composes;
- device-kind-aware bounds: ``client_mesh`` cells above the mesh
  entries (the visible cards, or ``--virtual_devices`` entries of one)
  are dropped (the driver would skip them), and on a card with a known
  memory size the activation-byte estimate is approximated per cell to
  drop batch sizes that cannot fit (``est_step_bytes``, the reference's
  estimate kept as it is; the card's measured peak is the profile
  session's ``peak_reserved_bytes``).

Cells enumerate in a deterministic order (declared axis order, value
order as declared) and are identified by a sha256 fingerprint of their
canonical JSON — the journal/resume key and the tie-breaker the search
sorts by.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json

from neuroimagedisttraining_tpu_torch.obs import probe as obs_probe

__all__ = ["Space", "build_space", "cell_fingerprint", "cell_valid",
           "est_step_bytes", "relevant_compat_rows", "PINNED",
           "DEFAULT_AXES", "HBM_BYTES_BY_KIND"]

#: knobs the tuner PINS instead of searching — part of the space's
#: identity (the compat predicates below depend on them)
PINNED = {"client_optimizer": "sgd", "loss_scale": 1.0,
          "algorithm": "fedavg"}

#: device memory by device kind (``torch.cuda.get_device_name``), bytes;
#: kinds not listed (cpu included) are unbounded here — host RAM is not
#: the contract this bound models
HBM_BYTES_BY_KIND = {
    "NVIDIA H100 80GB HBM3": 80 * 10 ** 9,
}

#: the default axes (the reference's); order is the enumeration order
DEFAULT_AXES: tuple[tuple[str, tuple], ...] = (
    ("precision", ("fp32", "bf16_mixed")),
    ("fused_update", (False, True)),
    ("remat", ("none", "stem")),
    ("client_mesh", (0, 2)),
    ("rounds_per_dispatch", (1, 4)),
    ("batch", (4, 8, 16)),
)


def cell_fingerprint(cell: dict) -> str:
    """Canonical-JSON sha256 prefix — the journal key, the recipe's
    winner id, and the deterministic tie-breaker."""
    canon = json.dumps(cell, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def relevant_compat_rows() -> tuple[dict, ...]:
    """The committed startup-rejection rows whose guard knobs all fall
    inside the tuned-or-pinned knob set — the rejection knowledge the
    validity predicates must (and do) satisfy. Rows reading knobs the
    tuner neither searches nor pins cannot constrain the space."""
    from neuroimagedisttraining_tpu_torch.analysis.compat_matrix import MATRIX

    knobs = {name for name, _ in DEFAULT_AXES} | set(PINNED)
    # the probe cell key "batch" rides OptimConfig.batch_size
    knobs |= {"batch_size"}
    return tuple(r for r in MATRIX if set(r["knobs"]) <= knobs)


def est_step_bytes(shape: tuple[int, ...], batch: int, precision: str,
                   remat) -> int:
    """Deterministic activation-footprint estimate of one train step
    (bytes/device): batch x voxels x a stem-channel expansion factor at
    the compute dtype, plus the fp32 master/grad residency — the
    reference's estimate, kept as it is (a cheap stand-in for the peak
    the profile session measures, with no step run). Remat divides the
    live-activation term (stem frees the widest early maps; full remat
    keeps ~one stage live)."""
    voxels = 1
    for s in shape:
        voxels *= int(s)
    act_bytes = 2 if precision == "bf16_mixed" else 4
    channels = 32  # stem feature-map expansion of the 3D-CNN family
    live = batch * voxels * channels * act_bytes
    policy = obs_probe.remat_policy(remat)
    if policy == "stem":
        live //= 2
    elif policy is True:
        live //= 4
    master = 64 << 20  # params + momentum + grads, f32 (model-scale)
    return int(live + master)


def cell_valid(cell: dict, *, n_devices: int = 1,
               hbm_bytes: int | None = None,
               shape: tuple[int, ...] = (12, 14, 12)
               ) -> tuple[bool, str]:
    """(ok, reason). Every predicate mirrors a startup rejection or
    driver skip — an invalid cell is one the CLIs/driver would refuse,
    never a taste judgment."""
    for key, value in cell.items():
        obs_probe.validate_cell_value(key, value)
    if cell.get("fused_update") and PINNED["client_optimizer"] != "sgd":
        # compat row (client_optimizer, fused_update): only the sgd
        # tail has a fused kernel
        return False, "fused_update requires the sgd optimizer"
    cm = int(cell.get("client_mesh", 0))
    if cm > n_devices:
        return False, (f"client_mesh={cm} needs {cm} devices, "
                       f"{n_devices} visible")
    if hbm_bytes:
        need = est_step_bytes(shape, int(cell.get("batch", 8)),
                              cell.get("precision", "fp32"),
                              cell.get("remat", "none"))
        if need > 0.92 * hbm_bytes:
            return False, (f"hbm-bound: ~{need >> 20} MiB estimated "
                           f"step footprint vs {hbm_bytes >> 20} MiB "
                           "device HBM")
    return True, ""


@dataclasses.dataclass(frozen=True)
class Space:
    """One declared search space: axes (ordered), the device context
    the validity predicates were evaluated against, and the harness
    shape the HBM estimate uses."""

    axes: tuple[tuple[str, tuple], ...]
    device_kind: str = "cpu"
    n_devices: int = 1
    shape: tuple[int, ...] = (12, 14, 12)
    hbm_bytes: int | None = None

    def __post_init__(self):
        known = set(obs_probe.CELL_KEYS)
        bad = [name for name, _ in self.axes if name not in known]
        if bad:
            raise ValueError(
                f"space names unknown axes {sorted(bad)}; tunable axes "
                f"are the probe cell keys: {obs_probe.CELL_KEYS}")
        for name, values in self.axes:
            if not values:
                raise ValueError(f"axis {name!r} has no values")
            for v in values:
                obs_probe.validate_cell_value(name, v)

    def fingerprint(self) -> str:
        canon = json.dumps(
            {"axes": [[n, list(vs)] for n, vs in self.axes],
             "device_kind": self.device_kind,
             "n_devices": self.n_devices,
             "shape": list(self.shape),
             "hbm_bytes": self.hbm_bytes,
             "pinned": {k: PINNED[k] for k in sorted(PINNED)}},
            sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(canon.encode()).hexdigest()[:16]

    def cells(self) -> tuple[list[dict], list[dict]]:
        """(valid, rejected) in deterministic enumeration order;
        rejected rows carry the predicate's reason (the session
        artifact records them — a bounded space must say what it
        dropped, not silently shrink)."""
        names = [n for n, _ in self.axes]
        valid: list[dict] = []
        rejected: list[dict] = []
        for combo in itertools.product(*(vs for _, vs in self.axes)):
            cell = dict(zip(names, combo))
            ok, reason = cell_valid(cell, n_devices=self.n_devices,
                                    hbm_bytes=self.hbm_bytes,
                                    shape=self.shape)
            if ok:
                valid.append(cell)
            else:
                rejected.append({"cell": cell, "reason": reason,
                                 "fingerprint": cell_fingerprint(cell)})
        return valid, rejected


def build_space(device_kind: str = "cpu", n_devices: int = 1,
                shape: tuple[int, ...] = (12, 14, 12),
                axes: tuple[tuple[str, tuple], ...] | None = None
                ) -> Space:
    """The default space for a device context: declared axes plus the
    device-kind memory bound (None on the CPU — host RAM is not
    modeled)."""
    hbm = HBM_BYTES_BY_KIND.get(device_kind)
    return Space(axes=tuple(axes) if axes is not None else DEFAULT_AXES,
                 device_kind=device_kind, n_devices=int(n_devices),
                 shape=tuple(int(s) for s in shape), hbm_bytes=hbm)
