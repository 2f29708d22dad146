"""The device mesh of one process (``parallel/``) against the reference
package's: the pads, the topology matrices and the mesh's shapes bit for
bit on grids; a sharded FedAvg and SalientGrads run on a 4-entry CPU mesh
bit for bit the port's unsharded run, and both held against the
reference's unsharded run at ``TRAJECTORY`` (the reference's own sharded
round fails on this toolchain, ``tests/test_cohort.py``); the two-level
silo-first mean on a 2x4 mesh, with and without ``norm_bound``, within
1e-6 relative of the reference's on the conftest's 8 virtual devices; the
gossip plans (offsets, weights, routing tables) equal to the reference's
on ring, random and full graphs, and the gossip consensus within 1e-6 of
the dense einsum and of the reference's; the depth-sharded convolution
within 1e-5 of the reference's and of ``F.conv3d``; two-level FedAvg and
D-PSGD over a ring on a mesh against their unsharded runs."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neuroimagedisttraining_tpu.data.synthetic import generate_synthetic_abcd

from torch_port_support import (
    LOSS_RTOL, TRAJECTORY, assert_state_close, run_engine_pair,
    torch_threads,
)

CPU = torch.device("cpu")
MODEL, SHAPE = "3dcnn_tiny", (12, 14, 12)


@pytest.fixture(autouse=True)
def _two_threads():
    """Every test of the module on 2 of torch's intra-op threads: the
    small models' ops gain nothing from more, and beside other test
    processes more threads than cores slow every one of them."""
    with torch_threads(2):
        yield


def _pmesh(n=None, shape=()):
    from neuroimagedisttraining_tpu_torch.parallel.mesh import (
        make_mesh, virtual_devices,
    )

    return make_mesh(num_devices=n, shape=shape,
                     devices=virtual_devices(8, CPU))


# ---------------------------------------------------------------- pads


def test_pad_cohort_equals_reference():
    from neuroimagedisttraining_tpu.parallel import cohort as jc
    from neuroimagedisttraining_tpu_torch.parallel import cohort

    rng = np.random.default_rng(0)
    for real in (1, 3, 5, 8, 21):
        for pad_clients in (0, 1, 3):
            total = real + pad_clients
            for d in (1, 2, 3, 4, 8):
                for s in range(1, real + 1):
                    sampled = np.sort(rng.choice(real, s, replace=False))
                    got = cohort.pad_cohort(sampled, real, total, d)
                    want = jc.pad_cohort(sampled, real, total, d)
                    assert got[1] == want[1]
                    assert got[0].dtype == want[0].dtype
                    np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(ValueError, match="empty sampled set"):
        cohort.pad_cohort(np.array([], np.int64), 3, 3, 2)


def test_pad_row_weights_and_pad_to_multiple_equal_reference():
    import jax.numpy as jnp

    from neuroimagedisttraining_tpu.parallel import cohort as jc
    from neuroimagedisttraining_tpu.parallel import mesh as jmesh
    from neuroimagedisttraining_tpu_torch.parallel import cohort, mesh

    for n in range(1, 9):
        ns = np.arange(3, 3 + n, dtype=np.int32)
        for n_real in range(0, n + 1):
            want = np.asarray(jc.pad_row_weights(jnp.asarray(ns), n_real))
            got = cohort.pad_row_weights(torch.from_numpy(ns), n_real)
            np.testing.assert_array_equal(got.numpy(), want)
    for n in range(0, 30):
        for d in range(1, 9):
            assert mesh.pad_to_multiple(n, d) == jmesh.pad_to_multiple(n, d)


# ------------------------------------------------------------ topology


def test_topology_matrices_equal_reference():
    from neuroimagedisttraining_tpu.parallel import topology as jt
    from neuroimagedisttraining_tpu_torch.parallel import topology as t

    for n in (1, 2, 3, 5, 8, 21):
        for k in (1, 2, 3, 4, 6):
            np.testing.assert_array_equal(t.ring_lattice(n, k),
                                          jt.ring_lattice(n, k))
            a = t.SymmetricTopologyManager(n, k).generate_topology()
            b = jt.SymmetricTopologyManager(n, k).generate_topology()
            np.testing.assert_array_equal(a, b)
            a = t.AsymmetricTopologyManager(
                n, k, 3, rng=np.random.default_rng(n * 10 + k))
            b = jt.AsymmetricTopologyManager(
                n, k, 3, rng=np.random.default_rng(n * 10 + k))
            np.testing.assert_array_equal(a.generate_topology(),
                                          b.generate_topology())
            for c in range(n):
                assert a.get_in_neighbor_idx_list(c) == \
                    b.get_in_neighbor_idx_list(c)
                assert a.get_out_neighbor_idx_list(c) == \
                    b.get_out_neighbor_idx_list(c)
        np.testing.assert_array_equal(t.ring_mixing_matrix(n),
                                      jt.ring_mixing_matrix(n))
        np.testing.assert_array_equal(t.full_mixing_matrix(n),
                                      jt.full_mixing_matrix(n))


# ---------------------------------------------------------------- mesh


def test_make_mesh_shapes_and_errors_equal_reference():
    from neuroimagedisttraining_tpu.parallel import mesh as jm
    from neuroimagedisttraining_tpu_torch.parallel import mesh

    devs = mesh.virtual_devices(8, CPU)
    for kw in (dict(), dict(num_devices=4), dict(shape=(2, 4)),
               dict(shape=(8,)), dict(shape=(1, 1))):
        a, b = mesh.make_mesh(devices=devs, **kw), jm.make_mesh(**kw)
        assert a.shape == tuple(b.devices.shape)
        assert a.axis_names == tuple(b.axis_names)
    for kw in (dict(shape=(3, 3)), dict(num_devices=9), dict(shape=(1, 2, 3)),
               dict(shape=(0,))):
        with pytest.raises(ValueError) as want:
            jm.make_mesh(**kw)
        with pytest.raises(ValueError) as got:
            mesh.make_mesh(devices=devs, **kw)
        assert str(got.value) == str(want.value)


def test_shard_federation_places_client_blocks():
    from neuroimagedisttraining_tpu_torch.parallel.mesh import (
        shard_federation,
    )

    m = _pmesh(4)
    x = torch.arange(8 * 3).reshape(8, 3)
    out = shard_federation({"x": x}, m)["x"]
    assert [b.tolist() for b in out] == [x[i:i + 2].tolist()
                                         for i in range(0, 8, 2)]
    with pytest.raises(ValueError, match="does not tile"):
        shard_federation({"x": x[:7]}, m)


# ------------------------------------------------------ sharded rounds


def _cohort():
    c = generate_synthetic_abcd(num_subjects=24, shape=SHAPE, num_sites=4,
                                seed=7)
    rows = np.arange(24).reshape(4, 6)
    tr = {i: rows[i, :3 + i % 2].astype(np.int64) for i in range(4)}
    te = {i: rows[i, 4:].astype(np.int64) for i in range(4)}
    return c["X"], c["y"], tr, te


@pytest.mark.parametrize("name", ["fedavg", "salientgrads"])
def test_sharded_round_is_the_unsharded_round(name, tmp_path):
    fed = dict(client_num_in_total=4, comm_round=2, frac=0.75,
               frequency_of_the_test=1)
    with torch_threads(2):
        jres, pres, jeng, peng, init = run_engine_pair(
            name, _cohort(), dict(batch_size=2, epochs=1), fed, tmp_path,
            shape=SHAPE, model=MODEL)
        sharded = peng.rebuild(dict(client_mesh=4), _pmesh(4))
        assert sharded._cohort_on
        sres = sharded.rerun()
    # the engine's announcements are in its experiment log, as the
    # reference's tests read them
    with open(sharded.log.log_path) as f:
        assert "cohort sharding armed" in f.read()
    for k in pres["params"]:
        assert torch.equal(pres["params"][k], sres["params"][k]), k
        assert torch.equal(pres["batch_stats"].get(k, torch.zeros(())),
                           sres["batch_stats"].get(k, torch.zeros(())))
    assert [h["train_loss"] for h in pres["history"]] == \
        [h["train_loss"] for h in sres["history"]]
    assert_state_close(sres["params"], sres["batch_stats"], jres["params"],
                       jres["batch_stats"], init[0], **TRAJECTORY)
    np.testing.assert_allclose(
        [h["train_loss"] for h in sres["history"]],
        [float(h["train_loss"]) for h in jres["history"]], rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", ["fedavg", "dpsgd"])
def test_sharded_window_is_the_unsharded_single_round(name):
    """Sharding composes with windows (the reference's pin): a K=3 run on
    a 4-entry mesh is bit for bit the K=1 run without a mesh, on the same
    padded federation (D-PSGD trains every client, so its mesh pads
    nothing)."""
    from test_torch_program import _final_state, _losses, _port_engine

    with torch_threads(2):
        single = _port_engine(name, 1, virtual_devices=4)
        single.mesh = None
        r1 = single.train()
        win = _port_engine(name, 3, virtual_devices=4, client_mesh=4)
        assert win._cohort_on and win.fused_fallback_key() is None
        r3 = win.train()
    s1, s3 = _final_state(r1), _final_state(r3)
    for k in s1:
        assert torch.equal(s1[k], s3[k]), k
    assert _losses(r1) == _losses(r3)


def _padding_engine(name: str, virtual_devices: int, client_mesh: int):
    """``name`` on the 4 site clients of the synthetic cohort; a mesh of 3
    entries pads the federation with 2 clients of no rows."""
    from neuroimagedisttraining_tpu_torch.__main__ import build_experiment
    from neuroimagedisttraining_tpu_torch.config import (
        DataConfig, ExperimentConfig, FedConfig, OptimConfig,
    )

    cfg = ExperimentConfig(
        model=MODEL, algorithm=name,
        data=DataConfig(dataset="synthetic", synthetic_shape=SHAPE,
                        synthetic_num_subjects=32,
                        val_fraction=0.25 if name == "fedfomo" else 0.0),
        optim=OptimConfig(batch_size=4, epochs=1),
        fed=FedConfig(client_num_in_total=4, comm_round=3, frac=0.5,
                      frequency_of_the_test=1, client_mesh=client_mesh),
        virtual_devices=virtual_devices)
    return build_experiment(cfg, "cpu")[0]


@pytest.mark.parametrize("name", ["dpsgd", "fedfomo", "dispfl"])
def test_mesh_padding_moves_no_real_clients_draws(name):
    """A client of no rows draws nothing from the trainer's generator, so
    a run on a 3-entry mesh (the 4 site clients padded with 2 empty ones)
    is bit for bit the unmeshed run of the 4 clients alone, as the
    reference's per-client keys make its own."""
    plain = _padding_engine(name, 0, 0)
    meshed = _padding_engine(name, 3, 3)
    assert (plain.num_clients, meshed.num_clients) == (4, 6)
    assert meshed.mesh.devices.size == 3
    assert meshed._cohort_on == (name == "dpsgd")   # the others: unsharded
    a, b = plain.train(), meshed.train()
    for pa, pb in zip(a["personal_params"], b["personal_params"][:4]):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k
    assert a["history"] == b["history"]


def test_cohort_map_keeps_client_order_and_pads():
    from neuroimagedisttraining_tpu_torch.parallel import cohort

    m = _pmesh(4)
    out = cohort.cohort_map(m, lambda x: x * 2, list(range(8)), CPU)
    assert out == [2 * i for i in range(8)]
    with pytest.raises(ValueError, match="does not tile"):
        cohort.cohort_map(m, lambda x: x, list(range(6)), CPU)
    with pytest.raises(ValueError, match="1-D client mesh"):
        cohort.cohort_map(_pmesh(shape=(2, 2)), lambda x: x, [0] * 4, CPU)
    assert cohort.sequential_map(lambda x: x + 1, [1, 2]) == [2, 3]


# ---------------------------------------------------------- two-level


def _stacks(C=8, seed=0):
    rng = np.random.default_rng(seed)
    tree = {"a": rng.standard_normal((C, 5, 3)).astype(np.float32),
            "b": rng.standard_normal((C, 7)).astype(np.float32)}
    w = rng.integers(1, 9, C).astype(np.float32)
    glob = {k: rng.standard_normal(v.shape[1:]).astype(np.float32)
            for k, v in tree.items()}
    return tree, w, glob


@pytest.mark.parametrize("norm_bound", [None, 0.5])
def test_silo_then_global_mean_matches_reference(norm_bound):
    import jax.numpy as jnp

    from neuroimagedisttraining_tpu.parallel.hierarchical import (
        make_two_level_mesh as jmake, silo_then_global_mean as jmean,
    )
    from neuroimagedisttraining_tpu_torch.core import robust
    from neuroimagedisttraining_tpu_torch.parallel.hierarchical import (
        is_two_level, make_two_level_mesh, silo_then_global_mean,
    )

    tree, w, glob = _stacks()
    want = jmean({k: jnp.asarray(v) for k, v in tree.items()},
                 jnp.asarray(w), jmake(2, 4),
                 global_params=({k: jnp.asarray(v) for k, v in glob.items()}
                                if norm_bound else None),
                 norm_bound=norm_bound)
    m = make_two_level_mesh(2, 4, devices=[CPU] * 8)
    assert is_two_level(m) and not is_two_level(_pmesh(4))
    states = [{k: torch.from_numpy(v[c]) for k, v in tree.items()}
              for c in range(8)]
    got = silo_then_global_mean(
        states, torch.from_numpy(w), m,
        global_params=({k: torch.from_numpy(v) for k, v in glob.items()}
                       if norm_bound else None), norm_bound=norm_bound)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    if norm_bound is None:
        flat = robust.weighted_mean(states, torch.from_numpy(w))
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), flat[k].numpy(),
                                       rtol=1e-6, atol=1e-7)


def test_two_level_fedavg_routes_silo_first(tmp_path):
    fed = dict(client_num_in_total=4, comm_round=2, frac=1.0,
               frequency_of_the_test=1)
    with torch_threads(2):
        jres, pres, jeng, peng, init = run_engine_pair(
            "fedavg", _cohort(), dict(batch_size=2, epochs=1), fed, tmp_path,
            shape=SHAPE, model=MODEL)
        two = peng.rebuild(None, _pmesh(shape=(2, 2)))
        calls = []
        from neuroimagedisttraining_tpu_torch.parallel import hierarchical
        orig = hierarchical.silo_then_global_mean
        hierarchical.silo_then_global_mean = lambda *a, **k: (
            calls.append(1), orig(*a, **k))[1]
        try:
            tres = two.train(init_state=init)
        finally:
            hierarchical.silo_then_global_mean = orig
        third = peng.rebuild(dict(frac=0.75), _pmesh(shape=(2, 2)))
        third.train(init_state=init)
    assert len(calls) == 4    # params and BatchNorm stats, 2 rounds
    for k in pres["params"]:
        np.testing.assert_allclose(tres["params"][k].numpy(),
                                   pres["params"][k].numpy(), rtol=1e-5,
                                   atol=1e-6)
    with open(third.log.log_path) as f:
        assert "falling back to the FLAT weighted mean" in f.read()


# ------------------------------------------------------------- gossip


def _graphs(C: int, rng):
    ring = np.zeros((C, C), np.float32)
    for c in range(C):
        ring[c, [c, (c - 1) % C, (c + 1) % C]] = 1.0 / 3
    rand = np.zeros((C, C), np.float32)
    for c in range(C):
        nei = rng.choice(np.delete(np.arange(C), c), 2, replace=False)
        rand[c, c] = 1.0
        rand[c, nei] = 1.0
    band = np.zeros((C, C), np.float32)
    for c in range(C):
        nei = [(c + o) % C for o in (-2, -1, 1, 2) if rng.random() < 0.6]
        band[c, [c, *nei]] = 1.0 / (1 + len(nei))
    return {"ring": ring, "random": rand, "band": band,
            "full": np.full((C, C), 1.0 / C, np.float32)}


def _same_plan(a, b):
    """Equal plans: the same circulant offsets and weights, or the same
    sparse spec and routing tables, or both dense."""
    if a[0] is None or isinstance(a[0], tuple):
        assert a == b
        return
    assert type(a[0]).__name__ == type(b[0]).__name__ == "SparseSpec"
    assert (a[0].D, a[0].B, a[0].m, a[0].n_max) == \
        (b[0].D, b[0].B, b[0].m, b[0].n_max)
    assert set(a[1]) == set(b[1])
    for k in a[1]:
        assert a[1][k].dtype == b[1][k].dtype
        np.testing.assert_array_equal(a[1][k], b[1][k])


def test_gossip_plans_equal_reference():
    from neuroimagedisttraining_tpu.parallel import gossip as jg
    from neuroimagedisttraining_tpu.parallel.mesh import make_mesh as jmesh
    from neuroimagedisttraining_tpu_torch.parallel import gossip as g

    rng = np.random.default_rng(3)
    for C in (8, 16, 21):
        for D in (2, 4, 8):
            jm, pm = jmesh(num_devices=D), _pmesh(D)
            for kind, M in _graphs(C, rng).items():
                assert g.circulant_plan(M) == jg.circulant_plan(M)
                assert g.plan_fits_mesh(g.circulant_plan(M), pm, C) == \
                    jg.plan_fits_mesh(jg.circulant_plan(M), jm, C)
                a, b = g.sparse_plan(M, pm, C), jg.sparse_plan(M, jm, C)
                assert (a is None) == (b is None), (C, D, kind)
                if a is not None:
                    _same_plan(a, b)
                _same_plan(g.make_plan(M, pm, C), jg.make_plan(M, jm, C))
    assert g.make_plan(_graphs(8, rng)["ring"], None, 8) == (None, {})


@pytest.mark.parametrize("D", [2, 4])
def test_gossip_apply_matches_einsum_and_reference(D):
    import jax
    import jax.numpy as jnp

    from neuroimagedisttraining_tpu.parallel import gossip as jg
    from neuroimagedisttraining_tpu.parallel.mesh import make_mesh as jmesh
    from neuroimagedisttraining_tpu_torch.parallel import gossip as g

    rng = np.random.default_rng(D)
    C = 16
    jm, pm = jmesh(num_devices=D), _pmesh(D)
    tree = {"w": rng.standard_normal((C, 4, 3)).astype(np.float32),
            "b": rng.standard_normal((C, 5)).astype(np.float32)}
    seen = set()
    for kind, M in _graphs(C, rng).items():
        plan, arrays = g.make_plan(M, pm, C)
        if plan is None:
            continue
        ptree = {k: torch.from_numpy(v) for k, v in tree.items()}
        jtree = {k: jnp.asarray(v) for k, v in tree.items()}
        if isinstance(plan, g.SparseSpec):
            seen.add("sparse")
            got = g.gossip_apply_sparse(ptree, plan, arrays, pm)
            jplan, jarrays = jg.make_plan(M, jm, C)
            want = jg.gossip_apply_sparse(jtree, jplan, jarrays, jm)
        else:
            seen.add("circulant")
            got = g.gossip_apply(ptree, plan, pm)
            want = jg.gossip_apply(jtree, plan, jm)
        for k, v in tree.items():
            dense = np.einsum("cj,j...->c...", M.astype(np.float64),
                              v.astype(np.float64))
            np.testing.assert_allclose(got[k].numpy(), dense, rtol=1e-6,
                                       atol=1e-6, err_msg=(kind, k))
            np.testing.assert_allclose(got[k].numpy(),
                                       np.asarray(jax.device_get(want[k])),
                                       rtol=1e-6, atol=1e-6)
    assert seen == {"sparse", "circulant"}
    with pytest.raises(ValueError, match="plan=None"):
        g.gossip_apply(tree, None, pm)
    zero = g.gossip_apply({"w": torch.ones(4, 2)}, (), pm)
    assert torch.equal(zero["w"], torch.zeros(4, 2))


def test_dpsgd_ring_on_a_mesh_matches_its_einsum_run():
    from neuroimagedisttraining_tpu_torch.parallel import gossip

    from test_torch_program import _port_engine

    with torch_threads(2):
        # the same padded federation; no mesh: the dense einsum
        plain = _port_engine("dpsgd", 1, cs="ring", frac=0.1,
                             client_num_in_total=32, comm_round=2,
                             virtual_devices=4)
        plain.mesh = None
        res = plain.train()
        meshed = _port_engine("dpsgd", 1, cs="ring", frac=0.1,
                              client_num_in_total=32, comm_round=2,
                              client_mesh=4, virtual_devices=4)
        calls = []
        orig = gossip.gossip_apply, gossip.gossip_apply_sparse
        gossip.gossip_apply = lambda *a, **k: (calls.append("ring"),
                                               orig[0](*a, **k))[1]
        gossip.gossip_apply_sparse = lambda *a, **k: (
            calls.append("sparse"), orig[1](*a, **k))[1]
        try:
            mres = meshed.train()
        finally:
            gossip.gossip_apply, gossip.gossip_apply_sparse = orig
    assert meshed.mesh.devices.size == 4 and calls
    for a, b in zip(res["personal_params"], mres["personal_params"]):
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(),
                                       rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ spatial


@pytest.mark.parametrize("kd", [1, 3, 5])
def test_spatial_sharded_conv3d_matches_reference(kd):
    import jax.numpy as jnp

    from neuroimagedisttraining_tpu.parallel.spatial import (
        make_space_mesh as jspace, spatial_sharded_conv3d as jconv,
    )
    from neuroimagedisttraining_tpu_torch.parallel.spatial import (
        make_space_mesh, spatial_sharded_conv3d,
    )

    rng = np.random.default_rng(kd)
    x = rng.standard_normal((2, 8, 6, 5, 3)).astype(np.float32)
    k = rng.standard_normal((kd, 3, 3, 3, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(jconv(jnp.asarray(x), jnp.asarray(k), jspace(4),
                            jnp.asarray(b)))
    got = spatial_sharded_conv3d(torch.from_numpy(x), torch.from_numpy(k),
                                 make_space_mesh(devices=[CPU] * 4),
                                 torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plain = F.conv3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                     torch.from_numpy(k).permute(4, 3, 0, 1, 2),
                     torch.from_numpy(b), padding=(kd // 2, 1, 1))
    np.testing.assert_allclose(got, plain.permute(0, 2, 3, 4, 1).numpy(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        spatial_sharded_conv3d(torch.zeros(1, 6, 4, 4, 3),
                               torch.from_numpy(k),
                               make_space_mesh(devices=[CPU] * 4))
