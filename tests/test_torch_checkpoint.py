"""Checkpoints of the port (``utils/checkpoint.py``, the engines' hooks)
against the reference package's file contract and checkpoints.

- The file contract: ``ckpt_%08d.msgpack``, the newest 3 kept, ``None``
  for a missing directory, the round stored is the last completed one;
  tensors and generator states come back bit for bit.
- The encoding is flax's msgpack: an array above 1 GiB is chunked as
  flax chunks it (the bytes equal ``flax.serialization.msgpack_serialize``
  of the same tree), and a port checkpoint loads with
  ``flax.serialization.msgpack_restore``; for FedAvg and SalientGrads on
  ``3dcnn_tiny`` its key tree (and every model leaf's shape and dtype) is
  the reference engine's checkpoint's, the generator entry apart.
- For every engine that checkpoints, a run killed after round 1 and
  resumed in a fresh engine from round 1's checkpoint alone is bit for bit
  the uninterrupted 4-round run (models, masks, losses, metrics), and so
  is a run of K = 4 windows with ``--checkpoint_every 2``. Tolerance: none
  (``torch.equal``).
"""

import argparse
import shutil

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from neuroimagedisttraining_tpu_torch.codec import wire
from neuroimagedisttraining_tpu_torch.utils import checkpoint as ckpt
from torch_port_support import torch_threads

ENGINE_ARGS = {
    "fedavg": ("--frac", "0.75"),
    "fedavg_streamed": ("--frac", "0.75"),
    "turboaggregate": ("--frac", "0.75"),
    "subavg": ("--epochs", "2", "--dist_thresh", "0", "--acc_thresh", "0"),
    "dispfl": ("--frac", "0.5"),
    "dpsgd": ("--frac", "0.5"),
    "fedfomo": ("--val_fraction", "0.2", "--frac", "0.5"),
}
RESUMABLE = ("fedavg", "fedavg_streamed", "fedprox", "salientgrads",
             "ditto", "local", "subavg", "dispfl", "dpsgd", "fedfomo",
             "turboaggregate")
#: the engines that run windows (engines/program.py)
WINDOWED = ("fedavg", "fedprox", "salientgrads", "ditto", "local", "subavg",
            "dpsgd")


def _cfg(algorithm: str, ckdir: str, *extra: str):
    from neuroimagedisttraining_tpu_torch.__main__ import (
        add_args, config_from_args,
    )

    argv = ["--algorithm", algorithm.removesuffix("_streamed"), "--device",
            "cpu", "--dataset", "synthetic", "--model", "3dcnn_tiny",
            "--synthetic_shape", "12", "14", "12",
            "--synthetic_num_subjects", "32", "--client_num_in_total", "4",
            "--comm_round", "4", "--batch_size", "4", "--epochs", "1",
            "--checkpoint_dir", ckdir, "--checkpoint_every", "2",
            *ENGINE_ARGS.get(algorithm, ()), *extra]
    return config_from_args(add_args(argparse.ArgumentParser())
                            .parse_args(argv))


def _train(algorithm: str, ckdir: str, *extra: str) -> dict:
    from neuroimagedisttraining_tpu_torch.__main__ import build_experiment

    streamed = algorithm.endswith("_streamed")
    if streamed:
        extra += ("--stream_chunk_clients", "2")
    eng, _ = build_experiment(_cfg(algorithm, ckdir, *extra), "cpu",
                              streaming=streamed)
    try:
        return eng.train()
    finally:
        if eng.stream is not None:
            eng.stream.close()


def _states(res: dict) -> list:
    """Every model and mask state a result holds, by key, in order."""
    out = []
    for k in sorted(res):
        v = res[k]
        if k == "personal":
            v = v["params"] + v["batch_stats"]
        if isinstance(v, dict) and v and all(
                isinstance(x, torch.Tensor) for x in v.values()):
            out.append((k, v))
        elif isinstance(v, list) and v and isinstance(v[0], dict) and all(
                isinstance(x, torch.Tensor) for x in v[0].values()):
            out += [(f"{k}[{i}]", s) for i, s in enumerate(v)]
    return out


def _assert_same_run(a: dict, b: dict) -> None:
    sa, sb = _states(a), _states(b)
    assert [k for k, _ in sa] == [k for k, _ in sb]
    assert sa
    for (name, x), (_, y) in zip(sa, sb):
        assert list(x) == list(y), name
        for k in x:
            assert torch.equal(x[k], y[k]), (name, k)
    strip = [{k: v for k, v in h.items() if not k.endswith("_seconds")}
             for h in a["history"]]
    assert strip == [{k: v for k, v in h.items()
                      if not k.endswith("_seconds")} for h in b["history"]]
    for k in ("final_global", "final_personal"):
        assert a.get(k) == b.get(k), k


# ---------------------------------------------------------------------------
# the file contract
# ---------------------------------------------------------------------------


def test_roundtrip_tensors_and_generator_states(tmp_path):
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(7)
    torch.rand(5, generator=gen)  # an advanced state
    state = {"w": torch.from_numpy(rng.standard_normal((3, 4)).astype(
                 np.float32)),
             "mask": torch.from_numpy(rng.random(6) < 0.5),
             "nested": {"b": torch.arange(5, dtype=torch.int64)},
             "history": [{"round": 0, "train_loss": 0.5}],
             "gen": gen, "count": 3, "name": "x"}
    path = ckpt.save_checkpoint(str(tmp_path), 7, state)
    assert path.endswith("ckpt_00000007.msgpack")
    rnd, back = ckpt.load_checkpoint(str(tmp_path))
    assert rnd == 7
    np.testing.assert_array_equal(back["w"], state["w"].numpy())
    np.testing.assert_array_equal(back["mask"], state["mask"].numpy())
    np.testing.assert_array_equal(back["nested"]["b"], np.arange(5))
    assert back["history"] == state["history"]
    assert back["count"] == 3 and back["name"] == "x"
    g2 = torch.Generator()
    g2.set_state(back["gen"])
    assert torch.equal(torch.rand(8, generator=g2),
                       torch.rand(8, generator=gen))
    assert not list(tmp_path.glob("*.tmp"))


def test_prune_keeps_newest_three_and_missing_dir(tmp_path):
    for r in range(6):
        ckpt.save_checkpoint(str(tmp_path), r, {"r": r})
    assert ckpt.list_checkpoints(str(tmp_path)) == [3, 4, 5]
    assert ckpt.load_checkpoint(str(tmp_path))[0] == 5
    assert ckpt.load_checkpoint(str(tmp_path), 4) == (4, {"r": 4})
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path), 1)
    assert ckpt.load_checkpoint(str(tmp_path / "missing")) is None
    assert ckpt.list_checkpoints(str(tmp_path / "missing")) == []


def test_chunked_arrays_match_flax_bytes(tmp_path, monkeypatch):
    """With the chunk size patched small on both sides, a tree of arrays
    above it packs to flax's bytes and loads back through both loaders."""
    monkeypatch.setattr(wire, "_MAX_CHUNK", 1000)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    rng = np.random.default_rng(1)
    tree = {"round": 3, "state": {
        "big": rng.standard_normal((7, 97)).astype(np.float32),
        "small": np.arange(10, dtype=np.int32),
        "nest": {"big2": rng.random(2501) < 0.5}}}
    assert wire.msgpack_dumps(tree) == serialization.msgpack_serialize(tree)
    ckpt.save_checkpoint(str(tmp_path), 3, tree["state"])
    raw = (tmp_path / "ckpt_00000003.msgpack").read_bytes()
    for back in (wire.msgpack_loads(raw)["state"],
                 serialization.msgpack_restore(raw)["state"]):
        for k in ("big", "small"):
            np.testing.assert_array_equal(back[k], tree["state"][k])
        np.testing.assert_array_equal(back["nest"]["big2"],
                                      tree["state"]["nest"]["big2"])


def test_state_above_one_gib_is_chunked_and_loads_back(tmp_path):
    """A leaf of 1 GiB + 4 KiB (flax's real chunk size) saves as two
    chunks and loads back."""
    n = 2 ** 30 + 4096
    big = np.zeros(n, np.uint8)
    big[[0, 2 ** 30 - 1, 2 ** 30, n - 1]] = [1, 2, 3, 4]
    ckpt.save_checkpoint(str(tmp_path), 0, {"stack": big})
    raw = (tmp_path / "ckpt_00000000.msgpack").read_bytes()
    assert raw.count(b"__msgpack_chunked_array__") == 1
    del big
    back = ckpt.load_checkpoint(str(tmp_path))[1]["stack"]
    assert back.shape == (n,) and back.dtype == np.uint8
    np.testing.assert_array_equal(back[[0, 2 ** 30 - 1, 2 ** 30, n - 1]],
                                  [1, 2, 3, 4])
    assert int(back.sum(dtype=np.int64)) == 10


# ---------------------------------------------------------------------------
# the reference's checkpoints
# ---------------------------------------------------------------------------


def _key_tree(tree, leaves: bool):
    if isinstance(tree, dict):
        return {k: _key_tree(v, leaves) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_key_tree(v, leaves) for v in tree]
    if leaves and isinstance(tree, np.ndarray):
        return (tree.shape, tree.dtype.name)
    return type(tree).__name__ if leaves else None


def _reference_checkpoint(algorithm: str, ckdir: str) -> dict:
    from neuroimagedisttraining_tpu.config import (
        DataConfig, ExperimentConfig, FedConfig, OptimConfig,
    )
    from neuroimagedisttraining_tpu.core.trainer import LocalTrainer
    from neuroimagedisttraining_tpu.data.federate import federate_cohort
    from neuroimagedisttraining_tpu.data.synthetic import (
        generate_synthetic_abcd,
    )
    from neuroimagedisttraining_tpu.engines import create_engine
    from neuroimagedisttraining_tpu.models import create_model
    from neuroimagedisttraining_tpu.utils.logging import ExperimentLogger

    cohort = generate_synthetic_abcd(num_subjects=32, shape=(12, 14, 12),
                                     num_sites=4, seed=1024)
    cfg = ExperimentConfig(
        model="3dcnn_tiny", num_classes=1, algorithm=algorithm,
        data=DataConfig(dataset="synthetic", partition_method="site"),
        optim=OptimConfig(batch_size=4, epochs=1),
        fed=FedConfig(client_num_in_total=4, comm_round=1,
                      frac=0.75 if algorithm == "fedavg" else 1.0),
        log_dir=ckdir + "_log", checkpoint_dir=ckdir, checkpoint_every=1)
    trainer = LocalTrainer(create_model(cfg.model, num_classes=1),
                           cfg.optim, num_classes=1)
    fed, _ = federate_cohort(cohort, partition_method="site")
    eng = create_engine(algorithm, cfg, fed, trainer, logger=ExperimentLogger(
        ckdir + "_log", "synthetic", cfg.identity(), console=False))
    eng.train()
    raw = open(f"{ckdir}/ckpt_00000000.msgpack", "rb").read()
    return jax.tree.map(np.asarray, serialization.msgpack_restore(raw))


@pytest.mark.parametrize("algorithm", ["fedavg", "salientgrads"])
def test_port_checkpoint_has_the_reference_key_tree(tmp_path, algorithm):
    with torch_threads(2):
        _train(algorithm, str(tmp_path / "port"), "--comm_round", "1",
               "--checkpoint_every", "1")
    raw = (tmp_path / "port" / "ckpt_00000000.msgpack").read_bytes()
    port = serialization.msgpack_restore(raw)  # flax loads it
    ref = _reference_checkpoint(algorithm, str(tmp_path / "ref"))
    assert port["round"] == ref["round"] == 0
    gen = port["state"].pop("generator")
    assert list(gen) == [ckpt.GEN_MARK]
    assert _key_tree(port, False) == _key_tree(ref, False)
    for k in ("params", "batch_stats", "per_params", "per_bstats", "masks"):
        if k in ref["state"]:
            assert _key_tree(port["state"][k], True) == \
                _key_tree(ref["state"][k], True), k


# ---------------------------------------------------------------------------
# resume: bit for bit the uninterrupted run
# ---------------------------------------------------------------------------


def _resume_pair(tmp_path, algorithm: str, *extra: str):
    a, b = tmp_path / "a", tmp_path / "b"
    with torch_threads(2):
        full = _train(algorithm, str(a), *extra)
        assert ckpt.list_checkpoints(str(a)) == [1, 3]
        b.mkdir()
        shutil.copy(a / "ckpt_00000001.msgpack", b)  # killed after round 1
        resumed = _train(algorithm, str(b), *extra)
    assert ckpt.list_checkpoints(str(b)) == [1, 3]
    return full, resumed


@pytest.mark.parametrize("algorithm", RESUMABLE)
def test_resume_is_the_uninterrupted_run(tmp_path, algorithm):
    full, resumed = _resume_pair(tmp_path, algorithm)
    _assert_same_run(full, resumed)
    assert [h["round"] for h in resumed["history"]] == [0, 1, 2, 3]


@pytest.mark.parametrize("algorithm", WINDOWED)
def test_windowed_resume_is_the_uninterrupted_run(tmp_path, algorithm):
    """K = 4 with evaluations at rounds 0 and 3: windows [0], [1] (a
    checkpoint round) and [2, 3]; the resume starts at round 2's
    window."""
    full, resumed = _resume_pair(tmp_path, algorithm,
                                 "--rounds_per_dispatch", "4",
                                 "--frequency_of_the_test", "4")
    _assert_same_run(full, resumed)


def test_resumed_salientgrads_skips_phase_one(tmp_path, monkeypatch):
    from neuroimagedisttraining_tpu_torch.engines.salientgrads import (
        SalientGradsEngine,
    )

    a = tmp_path / "a"
    with torch_threads(2):
        _train("salientgrads", str(a))
        calls = []
        monkeypatch.setattr(SalientGradsEngine, "generate_global_mask",
                            lambda *args: calls.append(1))
        res = _train("salientgrads", str(a), "--comm_round", "5")
    assert calls == [] and len(res["history"]) == 5
