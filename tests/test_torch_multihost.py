"""The mesh that spans ranks: ``--multihost_coordinator``,
``--process_id`` and ``--num_processes`` over ``torch.distributed``
(gloo), on the CPU with two ranks on ``127.0.0.1``.

The flags parse as the reference's; a mesh in which a rank owns no entry,
or whose entries are out of rank order, is refused. Two CLI ranks of
``3dcnn_tiny`` (2 torch threads each) end every run with the model, bit
for bit, of the same command run in one process with ``--virtual_devices
2``: FedAvg on the 1-D ``--client_mesh 2`` and the two-level
``--mesh_shape 2 1`` mesh, D-PSGD's ring, SalientGrads' global mask, and
a streamed FedAvg. Each rank and the single process write their own
checkpoint directory, and the final checkpoints are compared whole. The
streamed feed's mesh placement is held against the reference's ``_put``
on the same cohort and meshes of the same shapes."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "neuroimagedisttraining_tpu_torch"
SHAPE = (12, 14, 12)
COMMON = ["--device", "cpu", "--model", "3dcnn_tiny", "--synthetic_shape",
          *map(str, SHAPE), "--client_num_in_total", "4", "--comm_round",
          "2", "--batch_size", "4", "--epochs", "1", "--frac", "0.75",
          "--checkpoint_every", "1"]
SYNTHETIC = ["--dataset", "synthetic", "--synthetic_num_subjects", "32"]
RANK_TIMEOUT = 90


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(argv, ckpt):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.Popen(
        [sys.executable, "-m", PORT, *argv, "--checkpoint_dir", str(ckpt)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _finish(procs):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _result(out):
    """The run's history and final metrics, from its result line."""
    doc = json.loads(out.splitlines()[-1])
    return doc["history"], doc.get("final_global")


def _last_checkpoint(ckpt):
    from neuroimagedisttraining_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )

    return load_checkpoint(str(ckpt))[1]


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}/{i}")
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


def _two_ranks_and_one(tmp_path, argv):
    """The command on two ranks and in one process with
    ``--virtual_devices 2``: each rank's last checkpoint (models, masks,
    ``stat_info``, history, the generator), equal to the single process's
    entry by entry; the checkpoints and the outputs."""
    port = _free_port()
    procs = [_cli([*argv, "--multihost_coordinator", f"127.0.0.1:{port}",
                   "--num_processes", "2", "--process_id", str(r)],
                  tmp_path / f"rank{r}") for r in (0, 1)]
    procs.append(_cli([*argv, "--virtual_devices", "2"], tmp_path / "one"))
    outs = _finish(procs)
    states = [_last_checkpoint(tmp_path / d)
              for d in ("rank0", "rank1", "one")]
    _assert_trees_equal(states[0], states[1])
    _assert_trees_equal(states[0], states[2])
    return states, outs


# ------------------------------------------------------------ the flags


MULTIHOST_ARGV = ["--multihost_coordinator", "10.0.0.1:8476",
                  "--num_processes", "4", "--process_id", "3",
                  "--mesh_shape", "4", "4"]


def test_multihost_flags_parse_as_reference_and_idle_rank_refused():
    import argparse

    from neuroimagedisttraining_tpu import __main__ as jmain
    from neuroimagedisttraining_tpu_torch.__main__ import (
        add_args, config_from_args,
    )
    from neuroimagedisttraining_tpu_torch.parallel.mesh import make_mesh

    jp = jmain.add_args(argparse.ArgumentParser())
    pp = add_args(argparse.ArgumentParser())
    jargs, pargs = jp.parse_args(MULTIHOST_ARGV), pp.parse_args(
        MULTIHOST_ARGV)
    for k in ("multihost_coordinator", "num_processes", "process_id"):
        assert getattr(pargs, k) == getattr(jargs, k), k
        assert getattr(pp.parse_args([]), k) == getattr(
            jp.parse_args([]), k), k
    cfg = config_from_args(pargs)
    assert (cfg.multihost_coordinator, cfg.num_processes,
            cfg.process_id) == ("10.0.0.1:8476", 4, 3)
    # every flag of the reference's main CLI parses in the port's
    ref = {o for a in jp._actions for o in a.option_strings}
    port = {o for a in pp._actions for o in a.option_strings}
    assert ref <= port, sorted(ref - port)
    # the config line stays the reference's where the flags are unset
    assert "multihost" not in config_from_args(pp.parse_args([])).to_json()
    cpu = [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match=r"rank\(s\) \[1\] without an "
                                         "entry"):
        make_mesh(num_devices=2, devices=cpu, ranks=[0, 0, 1])
    with pytest.raises(ValueError, match="without an entry"):
        make_mesh(shape=(1, 2), devices=cpu, ranks=[0, 0, 1],
                  process_id=1)
    with pytest.raises(ValueError, match="rank order"):
        make_mesh(devices=cpu[:2], ranks=[1, 0])
    m = make_mesh(shape=(2, 1), devices=cpu[:2], ranks=[0, 1], process_id=1)
    assert (m.local_entries, m.rank_of(0), m.num_processes) == ([1], 0, 2)
    assert m.flat().axis_names == ("clients",) and m.flat().entries == \
        m.entries


def test_init_multihost_refuses_a_bad_rank():
    from neuroimagedisttraining_tpu_torch.distributed import init_multihost

    with pytest.raises(ValueError, match="not a rank"):
        init_multihost("127.0.0.1:1", 2, 2)


# ---------------------------------------------- two ranks against one


@pytest.mark.parametrize("mesh", [
    ["--algorithm", "fedavg", "--client_mesh", "2"],
    ["--algorithm", "fedavg", "--mesh_shape", "2", "1"],
    # every client trains each round, then the ring gossips over the mesh
    ["--algorithm", "dpsgd", "--client_mesh", "2", "--frac", "0.5"]],
    ids=["client_mesh", "mesh_shape_2x1", "dpsgd_client_mesh"])
def test_two_rank_fedavg_is_the_single_process_run(tmp_path, mesh):
    states, outs = _two_ranks_and_one(tmp_path, [*SYNTHETIC, *COMMON, *mesh])
    # the ranks split the clients and exchanged the trained states; the
    # final results are the single process's
    for out in outs[:2]:
        assert "mesh of 2 processes" in out and "exchange:" in out
    assert _result(outs[0]) == _result(outs[1]) == _result(outs[2])


def test_two_rank_salientgrads_mask_is_the_single_process_mask(tmp_path):
    states, _ = _two_ranks_and_one(
        tmp_path, ["--algorithm", "salientgrads", *SYNTHETIC, *COMMON,
                   "--mesh_shape", "2", "1"])
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(np.asarray(v))

    walk(states[0]["masks"])
    kept = sum(int((x != 0).sum()) for x in leaves)
    assert 0 < kept < sum(x.size for x in leaves)  # a sparse global mask


def test_two_rank_streamed_fedavg_is_the_single_process_run(tmp_path):
    from neuroimagedisttraining_tpu_torch.data.synthetic import (
        write_synthetic_hdf5,
    )

    h5 = tmp_path / "cohort.h5"
    write_synthetic_hdf5(str(h5), num_subjects=32, shape=SHAPE,
                         num_sites=4, seed=3)
    _, outs = _two_ranks_and_one(
        tmp_path, ["--algorithm", "fedavg", "--dataset", "abcd_h5",
                   "--data_dir", str(h5), "--streaming",
                   "--stream_chunk_clients", "2", *COMMON,
                   "--client_mesh", "2"])
    for out in outs:  # each rank runs the streamed round whole
        assert "streaming rounds host-stage" in out
        assert "exchange:" not in out
    assert _result(outs[0]) == _result(outs[1]) == _result(outs[2])


# ------------------------------------------- the streamed feed's placement


@pytest.mark.parametrize("shape", [(2,), (2, 2)], ids=["1d", "2x2"])
def test_stream_placement_is_the_reference_put(tmp_path, shape):
    """Each served fetch's client blocks sit on their mesh entries as the
    reference's ``_put`` shards the same fetch: a round's ``[S, ...]``
    chunk on axis 0, a window's ``[K, S, ...]`` on axis 1."""
    from neuroimagedisttraining_tpu.data.hdf5 import (
        load_abcd_hdf5 as jload,
    )
    from neuroimagedisttraining_tpu.data.stream import (
        StreamingFederation as JFeed,
    )
    from neuroimagedisttraining_tpu.parallel.mesh import (
        make_mesh as jmake_mesh,
    )
    from neuroimagedisttraining_tpu_torch.data.federate import (
        federation_maps,
    )
    from neuroimagedisttraining_tpu_torch.data.hdf5 import load_abcd_hdf5
    from neuroimagedisttraining_tpu_torch.data.stream import (
        StreamingFederation,
    )
    from neuroimagedisttraining_tpu_torch.data.synthetic import (
        write_synthetic_hdf5,
    )
    from neuroimagedisttraining_tpu_torch.parallel.mesh import (
        make_mesh, virtual_devices,
    )

    h5 = tmp_path / "cohort.h5"
    write_synthetic_hdf5(str(h5), num_subjects=24, shape=(6, 7, 6),
                         num_sites=4, seed=5)
    lazy, jlazy = load_abcd_hdf5(str(h5), lazy=True), jload(str(h5),
                                                            lazy=True)
    tr, te, _, _ = federation_maps(lazy["site"], 42, 0.0)
    n = int(np.prod(shape))
    pm = make_mesh(shape=shape, devices=virtual_devices(n, "cpu"))
    jm = jmake_mesh(shape=shape)
    feed = StreamingFederation(lazy["X"], lazy["y"], tr, te, device="cpu",
                               mesh=pm)
    jfeed = JFeed(jlazy["X"], jlazy["y"], tr, te, mesh=jm)
    order = [d.id for d in jm.devices.reshape(-1)]
    ids = np.arange(4)
    window = [ids, ids[::-1]]
    try:
        fetches = []
        for fetch, jfetch, arg, axis in (
                (feed.get_train, jfeed.get_train, ids, 0),
                (feed.get_window, jfeed.get_window, window, 1)):
            fetches.append((fetch(arg), feed.placed, jfetch(arg), axis))
        for got, placed, want, axis in fetches:
            for full, blocks, ref in zip(got, placed, want):
                shards = sorted(
                    (order.index(s.device.id), s.index[axis].start,
                     s.index[axis].stop, np.asarray(s.data))
                    for s in ref.addressable_shards)
                assert len(blocks) == len(shards) == n
                for (e, b), (je, lo, hi, data) in zip(blocks, shards):
                    assert e == je and b.device == pm.entries[e]
                    assert torch.equal(b, full.narrow(axis, lo, hi - lo))
                    assert np.array_equal(b.numpy(), data)
        # a chunk that does not tile the mesh stays whole
        feed.get_train(np.arange(3))
        assert feed.placed == (None, None, None)
    finally:
        feed.close()
        jfeed.close()
