"""Synthetic ABCD-like cohort generator (numpy; bit-identical to the
reference package's ``generate_synthetic_abcd`` for the same arguments).

The real ABCD cohort (T1 gray-matter volumes of 121x145x121 voxels, 8-bit
quantized, with ``X``/``y``/``site``) is private. This cohort has the same
schema: uint8 volumes, binary ``y`` (sex), integer ``site`` labels, and a
class-conditional blob whose position drifts by site.
"""

from __future__ import annotations

import numpy as np


def generate_synthetic_abcd(
    num_subjects: int = 256,
    shape: tuple[int, int, int] = (16, 16, 16),
    num_sites: int = 4,
    seed: int = 0,
    signal: float = 12.0,
) -> dict[str, np.ndarray]:
    """Returns ``{"X": uint8 [N,D,H,W], "y": int8 [N], "site": int16 [N]}``."""
    rng = np.random.default_rng(seed)
    d, h, w = shape
    y = rng.integers(0, 2, size=num_subjects).astype(np.int8)
    site_probs = rng.dirichlet(np.full(num_sites, 2.0))
    site = rng.choice(num_sites, size=num_subjects, p=site_probs).astype(np.int16)

    zz, yy, xx = np.meshgrid(
        np.linspace(-1, 1, d), np.linspace(-1, 1, h), np.linspace(-1, 1, w),
        indexing="ij",
    )
    X = np.empty((num_subjects, d, h, w), dtype=np.uint8)
    site_shift = rng.normal(0, 0.15, size=(num_sites, 3))
    for i in range(num_subjects):
        cz, cy, cx = site_shift[site[i]]
        blob = np.exp(-(((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2)
                        / 0.18))
        base = 60.0 + 20.0 * blob
        base += signal * blob * (1.0 if y[i] == 1 else -1.0)
        base += rng.normal(0, 8.0, size=shape)
        X[i] = np.clip(base, 0, 255).astype(np.uint8)
    return {"X": X, "y": y, "site": site}


def write_synthetic_hdf5(path: str, **kwargs) -> dict[str, np.ndarray]:
    """Write the synthetic cohort in the reference's HDF5 schema (datasets
    ``X``, ``y``, ``site``; ``X`` chunked a subject at a time), as the
    reference package's ``data/synthetic.py:53-64`` does. Returns the
    cohort."""
    import h5py

    data = generate_synthetic_abcd(**kwargs)
    with h5py.File(path, "w") as f:
        f.create_dataset("X", data=data["X"], chunks=(1,) + data["X"].shape[1:])
        f.create_dataset("y", data=data["y"])
        f.create_dataset("site", data=data["site"])
    return data
