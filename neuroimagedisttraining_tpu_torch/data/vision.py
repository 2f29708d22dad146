"""CIFAR-10/100 and TinyImageNet ingestion and the reference's vision
partition modes, numpy only (the reference package's ``data/vision.py``;
its upstream is fedml's ``cifar10/data_loader.py:75-249`` and the
cifar100 / tiny_imagenet mirrors).

Ingestion reads the canonical pickled batch folders
(``cifar-10-batches-py`` / ``cifar-100-python``) directly, a ``.npz`` with
``X_train`` / ``y_train`` / ``X_test`` / ``y_test`` for any dataset, and
the ``tiny-imagenet-200`` folder layout where PIL is installed;
``synthetic_vision_cohort`` draws class-separable images. uint8 images are
normalized at load by the per-channel mean and std of the reference's
transforms; the federation then holds them as float32 ``[N, H, W, C]``.

The partition modes share one sequential draw loop (``_draw_partition``):
equal client quotas, per-client class priors, then repeatedly pick a
random unfilled client, draw a class from its prior and pop an index from
that class's pool.

- ``n_cls``: priors uniform over ``int(alpha)`` random classes a client;
  an exhausted class pool gets a random-size refill (duplicates by
  design, as the reference).
- ``dir``: priors ~ Dirichlet(``alpha``); an exhausted class is redrawn,
  and after 100 redraws a random non-empty class is taken (the reference
  spins forever once all of a client's prior mass is exhausted).
- ``my_part``: ``alpha`` shard groups, each with one Dirichlet(0.3) prior
  shared by its clients; an exhausted pool resets to full.

Test sets are label-proportional per client: each client draws about
``|test| / clients`` rows from the global test pool in its training class
mix (``proportional_test_split``).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2435, 0.2616)
CIFAR100_MEAN = (0.5071, 0.4865, 0.4409)
CIFAR100_STD = (0.2673, 0.2564, 0.2762)
TINY_MEAN = (0.4802, 0.4481, 0.3975)
TINY_STD = (0.2770, 0.2691, 0.2821)

_STATS = {"cifar10": (CIFAR10_MEAN, CIFAR10_STD),
          "cifar100": (CIFAR100_MEAN, CIFAR100_STD),
          "tiny": (TINY_MEAN, TINY_STD)}


def _normalize(X_u8: np.ndarray, name: str) -> np.ndarray:
    mean, std = _STATS[name]
    X = X_u8.astype(np.float32) / 255.0
    return (X - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


# ---------------- ingestion ----------------

def _load_pickle_batches(data_dir: str, name: str):
    """Read the canonical CIFAR pickled batch folders without torchvision."""
    if name == "cifar10":
        folder = os.path.join(data_dir, "cifar-10-batches-py")
        train_files = [f"data_batch_{i}" for i in range(1, 6)]
        test_files = ["test_batch"]
        label_key = b"labels"
    else:
        folder = os.path.join(data_dir, "cifar-100-python")
        train_files, test_files = ["train"], ["test"]
        label_key = b"fine_labels"
    if not os.path.isdir(folder):
        return None

    def read(files):
        xs, ys = [], []
        for f in files:
            with open(os.path.join(folder, f), "rb") as fh:
                d = pickle.load(fh, encoding="bytes")
            xs.append(np.asarray(d[b"data"], np.uint8)
                      .reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            ys.append(np.asarray(d[label_key], np.int32))
        return np.concatenate(xs), np.concatenate(ys)

    Xtr, ytr = read(train_files)
    Xte, yte = read(test_files)
    return Xtr, ytr, Xte, yte


def _load_npz(data_dir: str):
    for cand in (data_dir, os.path.join(data_dir, "data.npz")):
        if os.path.isfile(cand) and cand.endswith(".npz"):
            z = np.load(cand)
            return (np.asarray(z["X_train"]), np.asarray(z["y_train"]),
                    np.asarray(z["X_test"]), np.asarray(z["y_test"]))
    return None


def _load_tiny_imagenet_folder(data_dir: str):
    """Canonical tiny-imagenet-200 ImageFolder layout (the reference's
    loader wraps it in torchvision ImageFolder,
    tiny_imagenet/data_loader.py:81-121): train/<wnid>/images/*.JPEG with
    classes in sorted-wnid order; val/ images labeled by
    val_annotations.txt. Requires PIL; returns None when layout absent."""
    root = data_dir
    if os.path.isdir(os.path.join(data_dir, "tiny-imagenet-200")):
        root = os.path.join(data_dir, "tiny-imagenet-200")
    train_dir = os.path.join(root, "train")
    val_dir = os.path.join(root, "val")
    if not (os.path.isdir(train_dir) and os.path.isdir(val_dir)):
        return None
    try:
        from PIL import Image
    except ImportError:
        return None

    wnids = sorted(d for d in os.listdir(train_dir)
                   if os.path.isdir(os.path.join(train_dir, d)))
    cls = {w: i for i, w in enumerate(wnids)}  # ImageFolder sorted order

    def read(path):
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.uint8)

    Xtr, ytr = [], []
    for w in wnids:
        img_dir = os.path.join(train_dir, w, "images")
        for f in sorted(os.listdir(img_dir)):
            Xtr.append(read(os.path.join(img_dir, f)))
            ytr.append(cls[w])
    Xte, yte = [], []
    ann = os.path.join(val_dir, "val_annotations.txt")
    with open(ann) as fh:
        for line in fh:
            parts = line.split("\t")
            if len(parts) < 2 or parts[1] not in cls:
                continue
            Xte.append(read(os.path.join(val_dir, "images", parts[0])))
            yte.append(cls[parts[1]])
    return (np.stack(Xtr), np.asarray(ytr, np.int32),
            np.stack(Xte), np.asarray(yte, np.int32))


def load_vision_dataset(name: str, data_dir: str):
    """-> (X_train f32 normalized [N,H,W,C], y_train i32, X_test, y_test)."""
    if name in ("cifar10", "cifar100"):
        raw = _load_pickle_batches(data_dir, name) or _load_npz(data_dir)
    elif name == "tiny":
        raw = _load_tiny_imagenet_folder(data_dir) or _load_npz(data_dir)
    else:
        raise ValueError(f"unknown vision dataset {name!r}")
    if raw is None:
        raise FileNotFoundError(
            f"no {name} data under {data_dir!r}: expected the pickled batch "
            "folder or an .npz with X_train/y_train/X_test/y_test")
    Xtr, ytr, Xte, yte = raw
    if Xtr.dtype == np.uint8:
        Xtr, Xte = _normalize(Xtr, name), _normalize(Xte, name)
    return (Xtr.astype(np.float32), ytr.astype(np.int32),
            Xte.astype(np.float32), yte.astype(np.int32))


def synthetic_vision_cohort(num_train: int = 256, num_test: int = 96,
                            num_classes: int = 10, hw: int = 32,
                            seed: int = 0):
    """Tiny class-separable images for tests: class-k images carry a mean
    shift in a class-specific channel/quadrant pattern."""
    rng = np.random.default_rng(seed)

    def make(n):
        y = rng.integers(0, num_classes, size=n).astype(np.int32)
        X = rng.normal(size=(n, hw, hw, 3)).astype(np.float32)
        for k in range(num_classes):
            sel = y == k
            X[sel, k % hw, :, k % 3] += 2.5
        return X, y

    Xtr, ytr = make(num_train)
    Xte, yte = make(num_test)
    return Xtr, ytr, Xte, yte


# ---------------- partition modes ----------------

def _draw_partition(y: np.ndarray, quotas: np.ndarray, priors: np.ndarray,
                    mode: str, rs: np.random.RandomState
                    ) -> dict[int, np.ndarray]:
    """The reference's shared sequential-draw loop
    (data_loader.py:97-147, identical skeleton in all three modes)."""
    n_client, n_cls = priors.shape
    prior_cumsum = np.cumsum(priors, axis=1)
    idx_list = [np.where(y == k)[0] for k in range(n_cls)]
    cls_amount = np.asarray([len(ix) for ix in idx_list], np.int64)
    out: list[list[int]] = [[] for _ in range(n_client)]
    quotas = quotas.copy()
    while quotas.sum() > 0:
        c = rs.randint(n_client)
        if quotas[c] <= 0:
            continue
        quotas[c] -= 1
        redraws = 0
        while True:
            k = int(np.argmax(rs.uniform() <= prior_cumsum[c]))
            if cls_amount[k] <= 0:
                # classes with NO samples at all (sparse label sets in a
                # user .npz, or num_classes > observed classes) can never
                # refill — redraw like dir mode instead of crashing
                if len(idx_list[k]) == 0:
                    mode_here = "dir"
                else:
                    mode_here = mode
                if mode_here == "n_cls":
                    # random-size refill (data_loader.py:107-108)
                    cls_amount[k] = rs.randint(0, len(idx_list[k]))
                    continue
                if mode_here == "my_part":
                    cls_amount[k] = len(idx_list[k])  # full reset (:184)
                    continue
                # dir: redraw; guard against the reference's infinite spin
                redraws += 1
                if redraws > 100:
                    alive = np.flatnonzero(cls_amount > 0)
                    k = int(rs.choice(alive))
                else:
                    continue
            cls_amount[k] -= 1
            out[c].append(int(idx_list[k][cls_amount[k]]))
            break
    return {c: np.asarray(sorted(ix), np.int64) for c, ix in enumerate(out)}


def vision_partition(y_train: np.ndarray, client_number: int, alpha: float,
                     method: str, seed: int = 0,
                     num_classes: int | None = None
                     ) -> dict[int, np.ndarray]:
    rs = np.random.RandomState(seed)
    n_cls = int(num_classes if num_classes is not None
                else y_train.max() + 1)
    n = len(y_train)
    # lognormal(sigma=0) == deterministic equal quotas (data_loader.py:83-85)
    quotas = np.full(client_number, n / client_number)
    quotas = (quotas / quotas.sum() * n).astype(np.int64)

    if method == "n_cls":
        a = max(1, int(alpha))
        priors = np.zeros((client_number, n_cls))
        for c in range(client_number):
            chosen = rs.choice(n_cls, a, replace=False)
            priors[c, chosen] = 1.0 / a
    elif method == "dir":
        priors = rs.dirichlet([alpha] * n_cls, size=client_number)
    elif method == "my_part":
        n_shards = max(1, int(alpha))
        group_priors = rs.dirichlet([0.3] * n_cls, size=n_shards)
        per_group = max(1, client_number // n_shards)
        priors = np.stack([group_priors[min(c // per_group, n_shards - 1)]
                           for c in range(client_number)])
    else:
        raise ValueError(f"unknown vision partition {method!r}")
    return _draw_partition(y_train, quotas, priors, method, rs)


def proportional_test_split(y_test: np.ndarray, train_stats: dict,
                            client_number: int, seed: int = 0,
                            num_classes: int | None = None
                            ) -> dict[int, np.ndarray]:
    """Per-client test sets drawn from the global pool matching each
    client's train class mix (data_loader.py:216-234)."""
    rs = np.random.RandomState(seed)
    n_cls = int(num_classes if num_classes is not None else y_test.max() + 1)
    idx_by_cls = [np.where(y_test == k)[0] for k in range(n_cls)]
    per_client = int(np.ceil(len(y_test) / client_number))
    out = {}
    for c in range(client_number):
        counts = train_stats.get(c, {})
        total = max(1, sum(counts.values()))
        picks = []
        for k in range(n_cls):
            want = int(np.ceil(counts.get(k, 0) / total * per_client))
            if want <= 0:
                continue
            perm = rs.permutation(len(idx_by_cls[k]))
            picks.append(idx_by_cls[k][perm[:want]])
        out[c] = (np.sort(np.concatenate(picks)) if picks
                  else np.asarray([], np.int64))
    return out


# ---------------- federation assembly ----------------

def federate_vision(name: str, data_dir: str, partition_method: str,
                    alpha: float, client_number: int,
                    device: torch.device | str = "cuda",
                    val_fraction: float = 0.0, seed: int = 0,
                    synthetic: bool = False, num_classes: int | None = None,
                    synthetic_num: tuple[int, int] | None = None,
                    mesh_size: int = 1):
    """``(FederatedData on device, info)``: the vision counterpart of
    ``federate_cohort``, with separate train and test pools and the
    reference's partition modes (``n_cls``, ``dir``, ``my_part``, ``homo``,
    ``hetero``)."""
    from neuroimagedisttraining_tpu_torch.data import partition as P
    from neuroimagedisttraining_tpu_torch.data.federate import (
        build_federated_data,
    )

    if synthetic:
        # sizes default inside synthetic_vision_cohort (single source)
        Xtr, ytr, Xte, yte = synthetic_vision_cohort(
            *(synthetic_num or ()), seed=seed,
            num_classes=num_classes or 10)
    else:
        Xtr, ytr, Xte, yte = load_vision_dataset(name, data_dir)
    n_cls = int(num_classes if num_classes is not None else ytr.max() + 1)

    if partition_method in ("n_cls", "dir", "my_part"):
        train_map = vision_partition(ytr, client_number, alpha,
                                     partition_method, seed=seed,
                                     num_classes=n_cls)
    elif partition_method in ("homo", "hetero"):
        if partition_method == "homo":
            train_map = P.homo_partition(len(ytr), client_number, seed=seed)
        else:
            train_map = P.dirichlet_partition(ytr, client_number, alpha,
                                              seed=seed)
    else:
        raise ValueError(
            f"unknown vision partition_method {partition_method!r}")

    stats = P.record_data_stats(ytr, train_map)
    test_map = proportional_test_split(yte, stats, client_number, seed=seed,
                                       num_classes=n_cls)

    val_map = None
    if val_fraction > 0:  # FedFomo's validation split
        val_map, new_train = {}, {}
        rs = np.random.RandomState(seed + 1)  # one stream across clients
        for c, idx in train_map.items():
            idx = np.array(idx, copy=True)
            rs.shuffle(idx)
            nv = max(1, int(len(idx) * val_fraction))
            val_map[c], new_train[c] = idx[:nv], idx[nv:]
        train_map = new_train

    info = {"partition_method": partition_method, "stats": stats,
            "client_num": client_number,
            "train_counts": [int(len(train_map[c]))
                             for c in sorted(train_map)]}
    fed = build_federated_data(Xtr, ytr, train_map, test_map,
                               torch.device(device), val_map=val_map,
                               X_eval=Xte, y_eval=yte, mesh_size=mesh_size)
    return fed, info
