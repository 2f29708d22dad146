"""The HDF5 cohort reader: the reference's ABCD schema.

One file holds the datasets ``X`` (uint8 volumes), ``y`` (labels) and
``site`` (acquisition-site labels). ``y`` and ``site`` are read at once;
``X`` stays an open ``h5py`` dataset, read a few rows at a time by the
streamed feed (``data/stream.py``), or is read whole for a resident run.
The port's copy of the reference package's ``data/hdf5.py:19-65``, with
the same schema check, error text and row order. ``h5py`` is imported
where a file is opened, so the port imports without it.
"""

from __future__ import annotations

import numpy as np


def load_abcd_hdf5(path: str, lazy: bool = True) -> dict:
    """Open a cohort in the reference's HDF5 schema.

    Returns ``{"X": h5py.Dataset | ndarray, "y": ndarray, "site": ndarray,
    "file": h5py.File | None}``. With ``lazy=True`` ``X`` is the open
    dataset and the caller closes ``cohort["file"]``; with ``lazy=False``
    ``X`` is read into memory and the file is closed.
    """
    import h5py

    f = h5py.File(path, "r")
    for key in ("X", "y", "site"):
        if key not in f:
            f.close()
            raise KeyError(
                f"HDF5 cohort {path!r} missing dataset {key!r} "
                "(reference schema: X, y, site — ABCD/data_loader.py:112)")
    y = np.asarray(f["y"])
    site = np.asarray(f["site"])
    if lazy:
        return {"X": f["X"], "y": y, "site": site, "file": f}
    X = np.asarray(f["X"])
    f.close()
    return {"X": X, "y": y, "site": site, "file": None}


def fetch_rows(X_source, idx: np.ndarray) -> np.ndarray:
    """Rows ``X_source[idx]`` in the order asked for, ``idx`` unsorted and
    with repeats allowed. An ndarray goes through the native gather; an
    ``h5py`` dataset, whose fancy reads need increasing unique indices, is
    read at the sorted unique indices and re-expanded."""
    from neuroimagedisttraining_tpu_torch.utils import native

    idx = np.asarray(idx)
    if isinstance(X_source, np.ndarray):
        return native.gather_rows(X_source, idx)
    order = np.argsort(idx, kind="stable")
    sorted_idx, inv = idx[order], np.empty_like(order)
    inv[order] = np.arange(len(order))
    uniq, uniq_inverse = np.unique(sorted_idx, return_inverse=True)
    data = np.ascontiguousarray(X_source[uniq])
    return native.gather_rows(data, uniq_inverse[inv])
