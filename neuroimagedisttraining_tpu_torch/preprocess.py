"""L0 offline preprocessing: raw NIfTI cohort -> X/y/site HDF5.

The reference ships this stage as a notebook (Preprocess_ABCD.ipynb); this
module is the same pipeline as a runnable CLI, the port's own copy of the
reference package's ``preprocess.py`` (host-only numpy)::

    python -m neuroimagedisttraining_tpu_torch.preprocess \
        --raw_dir /data/ABCD/Raw_Data --subject_info ABCDSexSiteInfo.txt \
        --out cohort.h5

Pipeline parity (cells cited from the reference's Preprocess_ABCD.ipynb):

1. Subject discovery (cell 3): ``<raw_dir>/<subject>/Baseline/<anat_201*>/
   Sm6mwc1pT1.nii`` — first matching anat dir per subject wins; subjects
   without one are skipped.
2. Brain mask (cells 7-16): voxelwise MEAN over all subjects' volumes,
   thresholded at ``mask_threshold`` (reference: mean > 0.2).
3. Mask apply (cell 20): each subject's volume is multiplied by the
   binary mask.
4. Labels (cells 25-28): CSV columns ``female`` -> category codes = y,
   ``abcd_site`` -> label-encoded (sorted-unique index) = site.
5. Per-subject min-max + 8-bit quantization (cell 37):
   ``uint8(round((x - min) / (max - min) * 255))`` per subject.
   STORAGE NOTE: the notebook divides back by 255 and stores float; this
   framework stores the uint8 codes directly (4x smaller on disk and over
   PCIe — the trainer raw-casts uint8 -> float32 on the device,
   ``core/trainer.py`` ``LocalTrainer._prep``), so inputs span 0..255
   instead of 0..1. That is a constant input scale absorbed by the first
   conv's weights; use
   ``--store_float`` for the notebook's exact 0..1 float32 storage.
6. HDF5 schema (cell 30): one file with datasets ``X``, ``y``, ``site``
   — exactly what ``data/hdf5.py::load_abcd_hdf5`` consumes. Rows are
   written subject-at-a-time (the full cohort never has to fit in RAM).

NIfTI ingestion uses nibabel when available and otherwise falls back to
the built-in minimal NIfTI-1 reader below (plain + .gz single-file,
scl_slope/scl_inter applied like ``nib.get_fdata``).
"""

from __future__ import annotations

import argparse
import csv
import gzip
import os
import struct
import sys

import numpy as np

# NIfTI-1 datatype codes -> numpy dtypes (the subset real T1 maps use)
_NIFTI_DTYPES = {2: "u1", 4: "i2", 8: "i4", 16: "f4", 64: "f8",
                 256: "i1", 512: "u2", 768: "u4"}


# ---------------------------------------------------------------- NIfTI IO

def read_nifti(path: str) -> np.ndarray:
    """Volume as float32, scl_slope/inter applied (nib.get_fdata parity)."""
    try:
        import nibabel as nib  # optional dependency

        return np.asarray(nib.load(path).get_fdata(), np.float32)
    except ImportError:
        pass
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    if len(raw) < 348:
        raise ValueError(f"{path}: truncated NIfTI header")
    sizeof_hdr = struct.unpack("<i", raw[0:4])[0]
    bo = "<" if sizeof_hdr == 348 else ">"
    if struct.unpack(bo + "i", raw[0:4])[0] != 348:
        raise ValueError(f"{path}: not a NIfTI-1 file")
    dim = struct.unpack(bo + "8h", raw[40:56])
    shape = tuple(int(d) for d in dim[1: 1 + dim[0]])
    datatype = struct.unpack(bo + "h", raw[70:72])[0]
    vox_offset = int(struct.unpack(bo + "f", raw[108:112])[0])
    scl_slope = struct.unpack(bo + "f", raw[112:116])[0]
    scl_inter = struct.unpack(bo + "f", raw[116:120])[0]
    if datatype not in _NIFTI_DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dt = np.dtype(bo + _NIFTI_DTYPES[datatype])
    n = int(np.prod(shape))
    data = np.frombuffer(raw, dt, count=n, offset=vox_offset)
    data = data.reshape(shape, order="F").astype(np.float32)
    if np.isfinite(scl_slope) and scl_slope not in (0.0, 1.0):
        data = data * scl_slope
    if np.isfinite(scl_inter) and scl_inter != 0.0:
        data = data + scl_inter
    return data


def write_nifti(path: str, data: np.ndarray) -> None:
    """Minimal NIfTI-1 writer (float32, identity affine) — enough for the
    synthetic round-trip test and for exporting masks."""
    data = np.asarray(data, np.float32)
    hdr = bytearray(352)  # 348 header + 4-byte extension flag
    struct.pack_into("<i", hdr, 0, 348)
    dims = (data.ndim,) + data.shape + (1,) * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, 16)        # datatype = float32
    struct.pack_into("<h", hdr, 72, 32)        # bitpix
    struct.pack_into("<8f", hdr, 76, 1, 1, 1, 1, 1, 1, 1, 1)  # pixdim
    struct.pack_into("<f", hdr, 108, 352.0)    # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)      # scl_slope
    hdr[344:348] = b"n+1\x00"                  # magic: single-file
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(np.asarray(data, "<f4").tobytes(order="F"))


# ---------------------------------------------------------------- pipeline

def discover_subjects(raw_dir: str, anat_prefix: str = "anat_201",
                      volume_name: str = "Sm6mwc1pT1.nii"):
    """(subject_id, volume_path) pairs — cell 3's directory walk."""
    out = []
    for sid in sorted(os.listdir(raw_dir)):
        base = os.path.join(raw_dir, sid, "Baseline")
        if not os.path.isdir(base):
            continue
        for inside in sorted(os.listdir(base)):
            if inside.startswith(anat_prefix):
                for cand in (volume_name, volume_name + ".gz"):
                    p = os.path.join(base, inside, cand)
                    if os.path.exists(p):
                        out.append((sid, p))
                        break
                else:
                    continue
                break  # first matching anat dir wins (cell 3 fileFlag)
    return out


#: candidate subject-id columns, checked in order (ABCD uses subjectkey /
#: src_subject_id; the notebook's sheet carries none, hence the fallback)
_ID_COLUMNS = ("subjectkey", "src_subject_id", "subject_id", "subject", "id")


def _codes(vals):
    """pandas category codes == sorted-unique index (cells 25-28)."""
    uniq = sorted(set(vals))
    table = {v: i for i, v in enumerate(uniq)}
    return np.asarray([table[v] for v in vals])


def load_subject_info(path: str):
    """``female``/``abcd_site`` columns -> (female values, site values,
    ids, id column name) in file order. Values are RAW strings — category
    codes must be computed AFTER any join/subset, or a dropped row
    carrying a novel value would shift every kept subject's code. ``ids``
    is the subject-id column when one exists (so callers can join rows to
    discovered volumes by id instead of by position), else ``None``."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise ValueError(f"{path}: empty subject info")
    for col in ("female", "abcd_site"):
        if col not in rows[0]:
            raise ValueError(f"{path}: missing column {col!r}")
    female = [r["female"] for r in rows]
    site = [r["abcd_site"] for r in rows]
    ids, id_col = None, None
    for col in _ID_COLUMNS:
        if col in rows[0]:
            ids, id_col = [r[col] for r in rows], col
            break
    return female, site, ids, id_col


def quantize_subject(vol: np.ndarray) -> np.ndarray:
    """Per-subject min-max -> uint8 codes (cell 37)."""
    lo, hi = float(vol.min()), float(vol.max())
    norm = (vol - lo) / max(hi - lo, 1e-12)
    return (norm * 255).astype(np.uint8)


def preprocess_cohort(raw_dir: str, subject_info: str, out_path: str,
                      mask_threshold: float = 0.2,
                      anat_prefix: str = "anat_201",
                      volume_name: str = "Sm6mwc1pT1.nii",
                      store_float: bool = False,
                      log=print) -> dict:
    """Run the full pipeline; returns a summary dict."""
    import h5py

    subjects = discover_subjects(raw_dir, anat_prefix, volume_name)
    if not subjects:
        raise ValueError(f"no subjects with {volume_name} under {raw_dir}")
    female, site_raw, ids, id_col = load_subject_info(subject_info)
    if ids is not None:
        # join by subject id: a CSV row whose volume was skipped by
        # discovery must not shift every later subject's y/site
        table = {sid: i for i, sid in enumerate(ids)}
        if len(table) != len(ids):
            dupes = sorted({s for s in ids if ids.count(s) > 1})
            raise ValueError(
                f"subject info column {id_col!r} has duplicate ids "
                f"{dupes[:5]} — ambiguous join")
        missing = [sid for sid, _ in subjects if sid not in table]
        if missing:
            raise ValueError(
                f"subject info is missing {id_col!r} rows for discovered "
                f"volumes: {missing[:5]}"
                f"{'...' if len(missing) > 5 else ''} (if this column is "
                "not the directory subject id, rename it to re-enable "
                "positional pairing)")
        order = [table[sid] for sid, _ in subjects]
        female = [female[i] for i in order]
        site_raw = [site_raw[i] for i in order]
    elif len(female) != len(subjects):
        # positional pairing is only sound when the counts agree exactly
        raise ValueError(
            f"subject info has {len(female)} rows but {len(subjects)} "
            "volumes were discovered and no subject-id column "
            f"({'/'.join(_ID_COLUMNS)}) is present to join on — row-order "
            "pairing would silently misalign labels")
    # codes AFTER the join: dropped rows must not contribute categories
    y = _codes(female).astype(np.int8)
    site = _codes(site_raw).astype(np.int16)
    log(f"{len(subjects)} subjects discovered")

    # pass 1: voxelwise mean -> brain mask (cells 7-16)
    total = None
    for _, p in subjects:
        vol = read_nifti(p)
        total = vol if total is None else total + vol
    mask = (total / len(subjects)) > mask_threshold
    log(f"brain mask: {int(mask.sum())}/{mask.size} voxels "
        f"(threshold {mask_threshold})")

    # pass 2: mask -> per-subject min-max -> quantize -> stream rows out
    shape = mask.shape
    with h5py.File(out_path, "w") as f:
        X = f.create_dataset(
            "X", (len(subjects),) + shape,
            dtype=np.float32 if store_float else np.uint8,
            chunks=(1,) + shape)
        for i, (_, p) in enumerate(subjects):
            vol = read_nifti(p)
            if vol.shape != shape:
                raise ValueError(
                    f"{p}: shape {vol.shape} != mask shape {shape}")
            q = quantize_subject(vol * mask)
            X[i] = (q.astype(np.float32) / 255.0) if store_float else q
        f.create_dataset("y", data=y)
        f.create_dataset("site", data=site)
    log(f"wrote {out_path}: X{(len(subjects),) + shape} "
        f"{'float32' if store_float else 'uint8'}, y, site")
    return {"subjects": len(subjects), "shape": shape,
            "mask_voxels": int(mask.sum()),
            "sites": int(site.max()) + 1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="neuroimagedisttraining_tpu_torch.preprocess",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--raw_dir", required=True,
                    help="BIDS-ish root: <raw_dir>/<subject>/Baseline/"
                         "anat_201*/Sm6mwc1pT1.nii")
    ap.add_argument("--subject_info", required=True,
                    help="CSV with 'female' and 'abcd_site' columns "
                         "(ABCDSexSiteInfo.txt layout), rows in subject "
                         "order")
    ap.add_argument("--out", required=True, help="output HDF5 path")
    ap.add_argument("--mask_threshold", type=float, default=0.2)
    ap.add_argument("--anat_prefix", type=str, default="anat_201")
    ap.add_argument("--volume_name", type=str, default="Sm6mwc1pT1.nii")
    ap.add_argument("--store_float", action="store_true",
                    help="store X as float32 in [0,1] (the notebook's "
                         "exact values) instead of uint8 codes")
    args = ap.parse_args(argv)
    preprocess_cohort(args.raw_dir, args.subject_info, args.out,
                      mask_threshold=args.mask_threshold,
                      anat_prefix=args.anat_prefix,
                      volume_name=args.volume_name,
                      store_float=args.store_float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
