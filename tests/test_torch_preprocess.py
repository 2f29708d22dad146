"""The port's L0 preprocessing CLI against the reference package's: the
NIfTI reader and writer, and the whole pipeline (subject discovery, the
subject-info join, the brain mask, the per-subject uint8 quantization and
the HDF5 writer) on a tiny cohort of plain and gzipped NIfTI volumes; the
``X``, ``y`` and ``site`` datasets must be equal, with ``--store_float``
too. Host-only numpy."""

import csv
import os

import h5py
import numpy as np
import pytest

from neuroimagedisttraining_tpu import preprocess as JP
from neuroimagedisttraining_tpu_torch import preprocess as PP

SHAPE = (12, 14, 12)


@pytest.fixture()
def raw_cohort(tmp_path):
    """7 subjects in the reference's directory layout, written by the
    port's ``write_nifti`` (odd subjects gzipped), one subject directory
    without anatomy, and a subject-info CSV with an id column."""
    rng = np.random.default_rng(5)
    root = tmp_path / "raw"
    for i in range(7):
        v = rng.uniform(0.0, 0.05, SHAPE).astype(np.float32)
        v[3:9, 4:10, 3:9] += rng.uniform(0.5, 1.0, (6, 6, 6))
        d = root / f"sub{i:02d}" / "Baseline" / "anat_20180101"
        os.makedirs(d)
        name = "Sm6mwc1pT1.nii" + (".gz" if i % 2 else "")
        PP.write_nifti(str(d / name), v)
    os.makedirs(root / "sub_broken" / "Baseline")
    info = tmp_path / "info.csv"
    with open(info, "w", newline="") as f:
        w = csv.DictWriter(f, ["subject", "female", "abcd_site"])
        w.writeheader()
        for i in (6, 0, 1, 2, 3, 4, 5):  # joined by id, not by row order
            w.writerow({"subject": f"sub{i:02d}", "female": i % 2,
                        "abcd_site": f"site{i % 3:02d}"})
    return root, info


@pytest.mark.parametrize("name", ["v.nii", "v.nii.gz"])
def test_nifti_io_matches_the_reference(tmp_path, name):
    vol = np.random.default_rng(0).normal(size=SHAPE).astype(np.float32)
    p, j = str(tmp_path / f"p_{name}"), str(tmp_path / f"j_{name}")
    PP.write_nifti(p, vol)
    JP.write_nifti(j, vol)
    for path in (p, j):
        got = PP.read_nifti(path)
        assert np.array_equal(got, JP.read_nifti(path))
        assert np.array_equal(got, vol)


@pytest.mark.parametrize("store_float", [False, True])
def test_preprocess_matches_the_reference(raw_cohort, tmp_path, store_float):
    root, info = raw_cohort
    outs = {}
    for tag, mod in (("port", PP), ("ref", JP)):
        out = str(tmp_path / f"{tag}.h5")
        summary = mod.preprocess_cohort(str(root), str(info), out,
                                        store_float=store_float,
                                        log=lambda *a: None)
        outs[tag] = (out, summary)
    assert outs["port"][1] == outs["ref"][1]
    assert outs["port"][1]["subjects"] == 7
    with h5py.File(outs["port"][0]) as fp, h5py.File(outs["ref"][0]) as fr:
        for k in ("X", "y", "site"):
            a, b = fp[k][()], fr[k][()]
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        assert fp["X"].dtype == (np.float32 if store_float else np.uint8)


def test_cli_writes_the_cohort(raw_cohort, tmp_path):
    """``python -m neuroimagedisttraining_tpu_torch.preprocess``'s
    ``main``: the file the port's HDF5 reader loads."""
    from neuroimagedisttraining_tpu_torch.data.hdf5 import load_abcd_hdf5

    root, info = raw_cohort
    out = str(tmp_path / "cli.h5")
    assert PP.main(["--raw_dir", str(root), "--subject_info", str(info),
                    "--out", out]) == 0
    cohort = load_abcd_hdf5(out, lazy=False)
    assert cohort["X"].shape == (7,) + SHAPE
    assert cohort["X"].dtype == np.uint8
    assert cohort["y"].tolist() == [i % 2 for i in range(7)]
