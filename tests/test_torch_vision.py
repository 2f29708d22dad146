"""The port's vision data path held on the CPU against the reference
package's: every partition mode's index maps bit-equal (numpy
``RandomState`` draws in both), the proportional test split and the class
census, the synthetic image cohort, the pickle-batch, ``.npz`` and
tiny-imagenet readers on files the tests write, ``federate_vision``'s
stacks and the cohort partitions of ``federate_cohort``; then the CLI's
vision dispatch, its class defaults and its refusals."""

import pickle

import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.data import federate as JF
from neuroimagedisttraining_tpu.data import partition as JP
from neuroimagedisttraining_tpu.data import vision as JV
from neuroimagedisttraining_tpu.data.synthetic import generate_synthetic_abcd
from neuroimagedisttraining_tpu_torch.__main__ import (
    add_args, build_experiment, config_from_args, main,
)
from neuroimagedisttraining_tpu_torch.data import federate as PF
from neuroimagedisttraining_tpu_torch.data import partition as PP
from neuroimagedisttraining_tpu_torch.data import vision as PV

CPU = torch.device("cpu")
SEEDS = (0, 1, 7)


def _labels(n=600, n_cls=10, seed=0):
    return np.random.default_rng(seed).integers(0, n_cls, n).astype(np.int32)


def _same_maps(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for c in a:
        np.testing.assert_array_equal(a[c], b[c])
        assert np.asarray(a[c]).dtype == np.asarray(b[c]).dtype


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("method,alpha", [("n_cls", 2), ("dir", 0.3),
                                          ("my_part", 3)])
def test_vision_partition_bit_equal(method, alpha, seed):
    """``vision_partition`` (the shared draw loop: ``n_cls``'s refills,
    ``my_part``'s resets, ``dir``'s redraws) gives the reference's index
    maps exactly, with a class the labels never hold among the priors."""
    y = _labels(seed=seed)
    for n_cls in (None, 12):
        _same_maps(PV.vision_partition(y, 6, alpha, method, seed=seed,
                                       num_classes=n_cls),
                   JV.vision_partition(y, 6, alpha, method, seed=seed,
                                       num_classes=n_cls))


@pytest.mark.parametrize("seed", SEEDS)
def test_cohort_partitions_bit_equal(seed):
    """``homo``, ``hetero`` (Dirichlet with its min-10 retry and capacity
    correction), ``rescale``, the per-client 80/20 split and the class
    census equal the reference's."""
    y = _labels(400, n_cls=3, seed=seed)
    _same_maps(PP.homo_partition(len(y), 5, seed=seed),
               JP.homo_partition(len(y), 5, seed=seed))
    d_p = PP.dirichlet_partition(y, 5, 0.5, seed=seed)
    _same_maps(d_p, JP.dirichlet_partition(y, 5, 0.5, seed=seed))
    for a, b in zip(PP.rescale_partition(len(y), 5, seed=seed),
                    JP.rescale_partition(len(y), 5, seed=seed)):
        _same_maps(a, b)
    for a, b in zip(PP.train_test_split_per_client(d_p, seed=seed),
                    JP.train_test_split_per_client(d_p, seed=seed)):
        _same_maps(a, b)
    assert PP.record_data_stats(y, d_p) == JP.record_data_stats(y, d_p)


@pytest.mark.parametrize("seed", SEEDS)
def test_proportional_test_split_and_stats(seed):
    """The label-proportional test sets and the census they draw from."""
    y_tr, y_te = _labels(800, seed=seed), _labels(300, seed=seed + 10)
    m = PV.vision_partition(y_tr, 4, 2, "n_cls", seed=seed)
    stats = PP.record_data_stats(y_tr, m)
    assert stats == JP.record_data_stats(y_tr, m)
    _same_maps(PV.proportional_test_split(y_te, stats, 4, seed=seed),
               JV.proportional_test_split(y_te, stats, 4, seed=seed))


def test_synthetic_vision_cohort_bit_equal():
    """The class-separable image cohort (``default_rng``) at the CLI's size
    and a small one with 100 classes."""
    for kw in ({}, dict(num_train=40, num_test=12, num_classes=100, hw=8,
                        seed=3)):
        for a, b in zip(PV.synthetic_vision_cohort(**kw),
                        JV.synthetic_vision_cohort(**kw)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def _write_cifar(root, name: str, rng) -> None:
    """A ``cifar-10-batches-py`` / ``cifar-100-python`` folder of uint8
    batches."""
    if name == "cifar10":
        folder = root / "cifar-10-batches-py"
        files = [(f"data_batch_{i}", 6) for i in range(1, 6)] + [
            ("test_batch", 5)]
        key = b"labels"
    else:
        folder = root / "cifar-100-python"
        files, key = [("train", 12), ("test", 5)], b"fine_labels"
    folder.mkdir()
    for f, n in files:
        d = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
             key: rng.integers(0, 10, n).tolist()}
        with open(folder / f, "wb") as fh:
            pickle.dump(d, fh)


@pytest.mark.parametrize("name", ["cifar10", "cifar100"])
def test_pickle_batch_reader_matches(name, tmp_path):
    """The canonical pickled batches, read and normalized by the channel
    means and stds, equal the reference's reading."""
    _write_cifar(tmp_path, name, np.random.default_rng(0))
    got = PV.load_vision_dataset(name, str(tmp_path))
    want = JV.load_vision_dataset(name, str(tmp_path))
    assert got[0].shape[1:] == (32, 32, 3) and got[0].dtype == np.float32
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_npz_and_tiny_imagenet_readers_match(tmp_path):
    """An ``.npz`` of uint8 images (normalized at load) and the
    tiny-imagenet-200 folder layout (PIL) read as the reference reads
    them."""
    from PIL import Image

    rng = np.random.default_rng(1)
    z = tmp_path / "z.npz"
    np.savez(z, X_train=rng.integers(0, 256, (9, 8, 8, 3), dtype=np.uint8),
             y_train=rng.integers(0, 4, 9),
             X_test=rng.integers(0, 256, (3, 8, 8, 3), dtype=np.uint8),
             y_test=rng.integers(0, 4, 3))
    root = tmp_path / "t" / "tiny-imagenet-200"
    wnids = ["n02", "n01"]
    for w in wnids:
        d = root / "train" / w / "images"
        d.mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (64, 64, 3),
                                         dtype=np.uint8)).save(
                d / f"{w}_{i}.JPEG")
    (root / "val" / "images").mkdir(parents=True)
    lines = []
    for i, w in enumerate(wnids):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3),
                                     dtype=np.uint8)).save(
            root / "val" / "images" / f"v{i}.JPEG")
        lines.append(f"v{i}.JPEG\t{w}\t0\t0\t1\t1\n")
    (root / "val" / "val_annotations.txt").write_text("".join(lines))
    for name, where in (("cifar10", z), ("tiny", tmp_path / "t")):
        got = PV.load_vision_dataset(name, str(where))
        for a, b in zip(got, JV.load_vision_dataset(name, str(where))):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        PV.load_vision_dataset("cifar100", str(tmp_path / "none"))


@pytest.mark.parametrize("method,val", [("n_cls", 0.0), ("dir", 0.25),
                                        ("my_part", 0.0), ("homo", 0.0),
                                        ("hetero", 0.0)])
def test_federate_vision_stacks_equal(method, val):
    """``federate_vision`` on the synthetic cohort: the padded float32 NHWC
    stacks, labels and counts of every split (the validation carve
    included) equal the reference's ``FederatedData``, and the partition
    info is the same."""
    alpha = 2 if method in ("n_cls", "my_part") else 0.5
    kw = dict(val_fraction=val, seed=3, synthetic=True,
              synthetic_num=(160, 48))
    pfed, pinfo = PV.federate_vision("cifar10", "", method, alpha, 4, CPU,
                                     **kw)
    jfed, jinfo = JV.federate_vision("cifar10", "", method, alpha, 4, **kw)
    assert pinfo == jinfo
    for k in ("X_train", "y_train", "n_train", "X_test", "y_test", "n_test",
              "X_val", "y_val", "n_val"):
        a, b = getattr(pfed, k), getattr(jfed, k)
        if b is None:
            assert a is None
            continue
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=k)
    assert pfed.X_train.dtype == torch.float32
    assert pfed.X_train.shape[2:] == (32, 32, 3)


@pytest.mark.parametrize("method", ["rescale", "dir", "hetero", "homo"])
def test_federate_cohort_partitions_equal(method):
    """``federate_cohort`` of a volume cohort by ``rescale`` / ``dir`` /
    ``hetero`` / ``homo`` at the reference's split seed: the uint8 stacks,
    labels, counts and the census equal the reference's."""
    c = generate_synthetic_abcd(num_subjects=60, shape=(4, 5, 4),
                                num_sites=3, seed=0)
    pfed, pinfo = PF.federate_cohort(c, CPU, 42, partition_method=method,
                                     client_number=3, alpha=0.5)
    jfed, jinfo = JF.federate_cohort(c, partition_method=method,
                                     client_number=3, alpha=0.5)
    assert pinfo["train_counts"] == jinfo["train_counts"]
    assert pinfo["stats"] == jinfo["stats"]
    for k in ("X_train", "y_train", "n_train", "X_test", "y_test", "n_test"):
        a = getattr(pfed, k)
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_array_equal(a, np.asarray(getattr(jfed, k)),
                                      err_msg=k)
    assert pfed.X_train.dtype == torch.uint8


def _cfg(*argv):
    import argparse

    return config_from_args(add_args(argparse.ArgumentParser()).parse_args(
        ["--device", "cpu", *argv]))


@pytest.mark.parametrize("dataset,classes", [
    ("cifar10", 10), ("CIFAR100", 100), ("tiny", 200),
    ("synthetic_vision", 10), ("synthetic", 1)])
def test_cli_class_defaults(dataset, classes):
    """A vision dataset implies its class count where ``--num_classes`` is
    1 (the default); a count given explicitly stands; ``--partition_method``
    / ``--partition_alpha`` reach the config and the experiment's identity
    (the reference's ``part-dir0.5``)."""
    cfg = _cfg("--dataset", dataset, "--partition_method", "dir",
               "--partition_alpha", "0.5")
    assert cfg.num_classes == classes
    assert cfg.data.partition_method == "dir"
    assert cfg.data.partition_alpha == 0.5
    assert "_part-dir0.5_" in cfg.identity()
    assert _cfg("--dataset", dataset, "--num_classes", "7").num_classes == 7


def test_cli_vision_dispatch_and_refusals():
    """``synthetic_vision`` builds a federation of 32x32x3 float images (a
    ``site`` partition means ``dir``) and a model for them; streaming a
    vision dataset, an unknown dataset (the error lists every dataset the
    port has) and an unknown model (the error names the port's models)
    raise."""
    cfg = _cfg("--dataset", "synthetic_vision", "--model", "cnn_cifar10",
               "--client_num_in_total", "4")
    eng, info = build_experiment(cfg, "cpu")
    assert info["partition_method"] == "dir" and info["file"] is None
    assert eng.data.X_train.dtype == torch.float32
    assert eng.sample_shape == (32, 32, 3)
    assert eng.trainer.model.fc3.weight.shape[0] == 10
    with pytest.raises(ValueError, match="ABCD-scale"):
        build_experiment(cfg, "cpu", streaming=True)
    with pytest.raises(ValueError) as e:
        build_experiment(_cfg("--dataset", "mnist"), "cpu")
    for name in ("abcd_h5", "synthetic", "cifar10", "cifar100", "tiny",
                 "synthetic_vision"):
        assert name in str(e.value)
    with pytest.raises(ValueError) as e:
        main(["--device", "cpu", "--dataset", "synthetic_vision",
              "--model", "darts_v3"])
    for name in ("resnet18", "vgg11", "resnet_meta", "3dcnn", "darts"):
        assert name in str(e.value)
