"""The port's data planes against the reference package's, on the CPU: the
HDF5 reader and writer, the native row gather, the streamed federation's
buffers byte for byte, its transfer counts, the split seed and the
``--dataset`` dispatch. No model runs here."""

import argparse

import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.data import hdf5 as JH
from neuroimagedisttraining_tpu.data import synthetic as JSYN
from neuroimagedisttraining_tpu.data.federate import (
    DATA_SPLIT_SEED, carve_val_split as j_carve,
)
from neuroimagedisttraining_tpu.data.partition import site_partition as j_site
from neuroimagedisttraining_tpu.data.stream import (
    StreamingFederation as JStream,
)
from neuroimagedisttraining_tpu_torch import __main__ as PM
from neuroimagedisttraining_tpu_torch.data import hdf5 as PH
from neuroimagedisttraining_tpu_torch.data import synthetic as PSYN
from neuroimagedisttraining_tpu_torch.data.federate import (
    _stack_pad, federation_maps,
)
from neuroimagedisttraining_tpu_torch.data.stream import StreamingFederation
from neuroimagedisttraining_tpu_torch.utils import native

SHAPE = (12, 14, 12)
COHORT = dict(num_subjects=48, shape=SHAPE, num_sites=4, seed=0)
# the smallest volume AlexNet3D takes, for the tests that build an engine
MODEL_SHAPE = (69, 69, 69)


@pytest.fixture(scope="module")
def h5_files(tmp_path_factory):
    """The same cohort written by each package's ``write_synthetic_hdf5``:
    ``(port_path, reference_path, cohort)``."""
    d = tmp_path_factory.mktemp("h5")
    port, ref = str(d / "port.h5"), str(d / "ref.h5")
    data = PSYN.write_synthetic_hdf5(port, **COHORT)
    JSYN.write_synthetic_hdf5(ref, **COHORT)
    return port, ref, data


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_bytes(a, b):
    a, b = _np(a), _np(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == \
        b.tobytes()


def test_hdf5_writer_and_reader_match_the_reference(h5_files):
    """Both writers give equal ``X``, ``y`` and ``site`` datasets with the
    same chunking; the readers give equal arrays, lazy and eager."""
    import h5py

    port, ref, data = h5_files
    with h5py.File(port) as fp, h5py.File(ref) as fr:
        for k in ("X", "y", "site"):
            assert _same_bytes(fp[k][()], fr[k][()]), k
            assert fp[k].chunks == fr[k].chunks, k
    for lazy in (True, False):
        p, j = PH.load_abcd_hdf5(port, lazy), JH.load_abcd_hdf5(ref, lazy)
        for k in ("X", "y", "site"):
            assert _same_bytes(p[k][()], j[k][()]), (lazy, k)
        assert (p["file"] is None) == (not lazy)
        for c in (p, j):
            if c["file"] is not None:
                c["file"].close()
    assert _same_bytes(PH.load_abcd_hdf5(port, False)["X"], data["X"])


def test_hdf5_missing_key_raises_the_reference_error(tmp_path):
    import h5py

    path = str(tmp_path / "bad.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("X", data=np.zeros((2, 3, 3, 3), np.uint8))
        f.create_dataset("y", data=np.zeros(2, np.int8))
    with pytest.raises(KeyError) as pe:
        PH.load_abcd_hdf5(path)
    with pytest.raises(KeyError) as je:
        JH.load_abcd_hdf5(path)
    assert str(pe.value) == str(je.value) and "'site'" in str(pe.value)


@pytest.mark.parametrize("idx", [[7, 2, 2, 41, 0, 7], [5], [47, 0, 3],
                                 [9, 9, 9]])
def test_fetch_rows_matches_the_reference(h5_files, idx):
    """Unsorted and repeated indices, from the h5py dataset and from an
    ndarray: the rows in the order asked for."""
    port, _, data = h5_files
    idx = np.asarray(idx)
    lazy = PH.load_abcd_hdf5(port, lazy=True)
    try:
        for src in (lazy["X"], data["X"]):
            got = PH.fetch_rows(src, idx)
            assert _same_bytes(got, JH.fetch_rows(src, idx))
            assert _same_bytes(got, data["X"][idx])
    finally:
        lazy["file"].close()


def test_native_gather_against_its_plain_version():
    """The g++-built gather equals ``gather_rows_plain``: into a fresh
    array, into the front of a padded chunk (the rest untouched), and for
    a non-uint8 source, which takes the plain path by design."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (20,) + SHAPE, dtype=np.uint8)
    idx = np.array([19, 3, 3, 0, 11])
    assert native.load() is not None
    assert native.library_path().exists()
    assert _same_bytes(native.gather_rows(src, idx),
                       native.gather_rows_plain(src, idx))
    out = np.full((2, 8) + SHAPE, 7, np.uint8)
    ref = out.copy()
    native.gather_rows(src, idx, out=out[1])
    native.gather_rows_plain(src, idx, out=ref[1])
    assert _same_bytes(out, ref)
    assert (out[1, len(idx):] == 7).all() and (out[0] == 7).all()
    f32 = src.astype(np.float32)
    assert _same_bytes(native.gather_rows(f32, idx), f32[idx])
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([20]))


def test_native_gather_build_failure_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises with the compiler's output: there is no
    quiet fallback to numpy."""
    bad = tmp_path / "gather.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for gather.cpp"):
        native.gather_rows(np.zeros((2, 3), np.uint8), np.array([1]))
    assert not native.library_path().exists()


def _feeds(h5_path, data, lazy: bool):
    """The port's and the reference's feeds over the same source (the
    open HDF5 dataset, or the in-memory array), with a validation split,
    and the HDF5 file to close."""
    cohort = PH.load_abcd_hdf5(h5_path, lazy=True)
    src = cohort["X"] if lazy else data["X"]
    tr, te, va, _ = federation_maps(data["site"], 42, 0.25)
    port = StreamingFederation(src, data["y"], tr, te, val_map=va,
                               device="cpu")
    ref = JStream(src, data["y"], tr, te, val_map=va)
    return port, ref, cohort["file"]


@pytest.mark.parametrize("lazy", [True, False], ids=["h5py", "ndarray"])
def test_stream_buffers_match_the_reference(h5_files, lazy):
    """``get_train`` after a hit prefetch, a cold read and a mismatched
    prefetch (never served stale); ``eval_chunks`` over train, test and
    val at a chunk size that pads the last chunk; ``get_val_resident``:
    byte for byte the reference's; the same fetches, and the bytes each
    copies."""
    port_path, _, data = h5_files
    port, ref, f = _feeds(port_path, data, lazy)
    try:
        def same(ids, n_real=None):
            got = port.get_train(ids, n_real)
            want = ref.get_train(ids, n_real)
            return all(_same_bytes(a, b) for a, b in zip(got, want))

        port.prefetch_train(np.array([2, 0]))
        ref.prefetch_train(np.array([2, 0]))
        assert same(np.array([2, 0]))                    # hit
        assert same(np.array([1, 3, 3]), n_real=2)       # cold, a pad
        port.prefetch_train(np.array([0, 1]))
        ref.prefetch_train(np.array([0, 1]))
        assert same(np.array([3]))                       # mismatch
        for split in ("train", "test", "val"):
            pc = list(port.eval_chunks(3, split))
            jc = list(ref.eval_chunks(3, split))
            assert len(pc) == len(jc) == 2
        # chunks are served from reused slabs: compare each as it comes
        for split in ("train", "test", "val"):
            for a, b in zip(port.eval_chunks(3, split),
                            ref.eval_chunks(3, split)):
                assert np.array_equal(a.ids, b.ids)
                assert np.array_equal(a.padded_ids, b.padded_ids)
                for x, y in zip(a[2:], b[2:]):
                    assert _same_bytes(x, y), split
        assert all(_same_bytes(a, b) for a, b in
                   zip(port.get_val_resident(), ref.get_val_resident()))
        port.sync()
        ref.sync()
        ps, js = port.transfer_stats, ref.transfer_stats
        assert ps["fetches"] == js["fetches"] == 4 + 12
        # the reference copies whole padded buffers, the port each
        # client's rows (and the int32 part whole)
        fetches = ([([2, 0], "train", None), ([1, 3, 3], "train", 2),
                    ([0, 1], "train", None), ([3], "train", None)]
                   + [(ids, split, len(real)) for split in ("train", "test",
                                                            "val")
                      for real, ids in port.chunk_plan(range(4), 3)] * 2)
        row = int(np.prod(SHAPE))
        want_p = want_j = 0
        for ids, split, n_real in fetches:
            idx_map, nmax = port._split_maps(split)
            n = sum(len(idx_map[int(c)]) for c in ids[:n_real])
            want_p += n * row + 4 * (len(ids) * nmax + len(ids))
            want_j += len(ids) * nmax * (row + 4) + 4 * len(ids)
        assert (ps["bytes"], js["bytes"]) == (want_p, want_j)
        assert ps["host_gather_ms"] > 0 and ps["device_put_ms"] > 0
    finally:
        port.close()
        ref.close()
        f.close()


def test_stream_walks_match_the_resident_stacks(h5_files):
    """A walk over a given id list (the engines' rounds) serves the rows of
    the resident ``_stack_pad``; the walk's ``then`` prefetch is served to
    the next walk without a second fetch; a walk whose next chunk was
    replaced raises."""
    _, _, data = h5_files
    tr, te, _, _ = federation_maps(data["site"], 42)
    port = StreamingFederation(data["X"], data["y"], tr, te, device="cpu")
    Xr, yr, nr = _stack_pad(data["X"], data["y"], tr)
    try:
        ids = np.array([3, 1, 2])
        walk = port.eval_chunks(2, "train", ids=ids,
                                then=(np.array([0, 2]), "test"))
        seen = []
        for ch in walk:
            for j, c in enumerate(ch.ids):
                assert _same_bytes(ch.X[j], Xr[c])
                assert _same_bytes(ch.y[j], yr[c])
                assert int(ch.n[j]) == nr[c]
                seen.append(int(c))
            if len(ch.ids) < 2:  # the pad client of the last chunk
                assert int(ch.n[1]) == 0 and not ch.X[1].any()
        assert seen == [3, 1, 2]
        port.sync()
        before = port.transfer_stats["fetches"]
        Xt, _, _ = _stack_pad(data["X"], data["y"], te)
        for ch in port.eval_chunks(2, "test", ids=np.array([0, 2])):
            assert _same_bytes(ch.X[0], Xt[0]) and _same_bytes(ch.X[1],
                                                               Xt[2])
        port.sync()
        assert port.transfer_stats["fetches"] == before   # prefetched
        walk = port.eval_chunks(1, "train", ids=np.array([0, 1]))
        next(walk)
        port.get_train(np.array([2]))   # replaces the walk's next chunk
        with pytest.raises(RuntimeError, match="interleaved"):
            next(walk)
    finally:
        port.close()


@pytest.mark.parametrize("val_fraction", [0.0, 0.25])
def test_seed_split_42_is_the_references_split(val_fraction):
    """At ``--seed_split 42`` the port's partition (and validation carve)
    is the reference package's, which splits with ``DATA_SPLIT_SEED``
    whatever the flag says."""
    site = JSYN.generate_synthetic_abcd(**COHORT)["site"]
    tr, te, va, _ = federation_maps(site, 42, val_fraction)
    jtr, jte, _ = j_site(site, seed=DATA_SPLIT_SEED)
    if val_fraction:
        jva, jtr = j_carve(jtr, val_fraction, seed=DATA_SPLIT_SEED)
        assert all(np.array_equal(va[c], jva[c]) for c in jva)
    assert DATA_SPLIT_SEED == 42
    for a, b in ((tr, jtr), (te, jte)):
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[c], b[c]) for c in a)


def _experiment(argv, streaming):
    args = PM.add_args(argparse.ArgumentParser()).parse_args(argv)
    return PM.build_experiment(PM.config_from_args(args), "cpu",
                               streaming=streaming)


def test_seed_split_7_is_followed_by_both_paths():
    """At ``--seed_split 7`` the port splits by 7 (not the reference's 42),
    and its resident and streamed paths hold the same train, test and
    validation rows."""
    argv = ["--dataset", "synthetic", "--synthetic_shape",
            *map(str, MODEL_SHAPE), "--synthetic_num_subjects", "24", "--client_num_in_total", "4",
            "--seed_split", "7", "--val_fraction", "0.25",
            "--algorithm", "fedfomo"]
    res, info = _experiment(argv, False)
    st, _ = _experiment(argv, True)
    split42, _ = _experiment([*argv, "--seed_split", "42"], False)
    assert not torch.equal(res.data.X_train, split42.data.X_train)
    assert info["train_counts"] == st.stream.n_train.tolist()
    for split in ("train", "test", "val"):
        X, y, n = res._resident(split)
        for ch in st.stream.eval_chunks(2, split):
            for j, c in enumerate(ch.ids):
                assert torch.equal(ch.X[j], X[c]), (split, c)
                assert torch.equal(ch.y[j], y[c]) and int(ch.n[j]) == n[c]
    st.stream.close()


def test_dataset_dispatch_and_defaults(tmp_path, monkeypatch):
    """``--dataset`` defaults to ``ABCD`` at ``./data`` as the reference's
    does; ``ABCD`` with a missing file raises and does not train on the
    synthetic cohort; a name the port has no loader for raises, listing
    what it has; ``abcd_h5`` reads the file."""
    args = PM.add_args(argparse.ArgumentParser()).parse_args([])
    assert (args.dataset, args.data_dir) == ("ABCD", "./data")
    cfg = PM.config_from_args(args)
    assert cfg.data.dataset == "abcd" and cfg.data.data_dir == "./data"

    path = str(tmp_path / "c.h5")
    data = PSYN.write_synthetic_hdf5(path, **{**COHORT, "num_subjects": 16,
                                              "shape": MODEL_SHAPE})

    def no_synthetic(**kw):
        raise AssertionError("drew the synthetic cohort")

    monkeypatch.setattr(PSYN, "generate_synthetic_abcd", no_synthetic)
    missing = str(tmp_path / "none.h5")
    for streaming in (False, True):
        with pytest.raises(OSError):
            _experiment(["--dataset", "ABCD", "--data_dir", missing],
                        streaming)
        with pytest.raises(OSError):
            PM.main(["--dataset", "ABCD", "--data_dir", missing,
                     "--device", "cpu"] + (["--streaming"] if streaming
                                          else []))
    with pytest.raises(ValueError, match="abcd/abcd_h5/synthetic"):
        _experiment(["--dataset", "mnist"], False)
    with pytest.raises(FileNotFoundError):  # a vision loader, no files
        _experiment(["--dataset", "cifar10", "--data_dir", missing], False)
    eng, info = _experiment(["--dataset", "abcd_h5", "--data_dir", path,
                             "--client_num_in_total", "4"], False)
    Xr, _, _ = _stack_pad(data["X"], data["y"], federation_maps(
        data["site"], 42)[0])
    assert info["file"] is None and _same_bytes(eng.data.X_train, Xr)
    eng, info = _experiment(["--dataset", "abcd_h5", "--data_dir", path],
                            True)
    assert info["file"] is not None and eng.data is None
    assert eng.stream.sample_shape == MODEL_SHAPE
    eng.stream.close()
    info["file"].close()
