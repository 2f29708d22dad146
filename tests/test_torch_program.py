"""Round programs and dispatch (``engines/program.py``) against the
reference package's: the reason table, every engine's fallback keys on the
same configurations, the window planner (``dispatch_window`` over a grid,
D-PSGD's extra hook, ``window_sampling`` under a crash schedule), windows
on the CPU (a K=3 run bit for bit its K=1 run for every engine that
fuses, one host read a window, the window's log lines in round order, the
static-buffer steps of the graphed path counted), FedAvg and SalientGrads
windows held against the reference's fused window at ``TRAJECTORY``
(losses at ``LOSS_RTOL``), FedAvg's streamed window equal to its resident
one, and the CLI's new flags and startup errors against the reference's.
Tiny3DCNN at 12x14x12 throughout."""

import dataclasses
import functools
import logging
import math

import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.data.synthetic import generate_synthetic_abcd

from torch_port_support import (
    LOSS_RTOL, TRAJECTORY, assert_state_close, run_engine_pair,
    torch_threads,
)

MODEL, SHAPE = "3dcnn_tiny", (12, 14, 12)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _two_threads():
    """Every test of the module on 2 of torch's intra-op threads: the
    small models' ops gain nothing from more, and beside other test
    processes more threads than cores slow every one of them."""
    with torch_threads(2):
        yield
NAMES = ["fedavg", "fedprox", "salientgrads", "ditto", "local", "subavg",
         "dispfl", "dpsgd", "fedfomo", "turboaggregate"]
FUSING = ["fedavg", "fedprox", "salientgrads", "ditto", "local", "subavg",
          "dpsgd"]


def _maps(clients: int = 4, per: int = 6):
    c = generate_synthetic_abcd(num_subjects=clients * per, shape=SHAPE,
                                num_sites=clients, seed=5)
    rows = np.arange(clients * per).reshape(clients, per)
    tr = {i: rows[i, :3].astype(np.int64) for i in range(clients)}
    va = {i: rows[i, 3:4].astype(np.int64) for i in range(clients)}
    te = {i: rows[i, 4:].astype(np.int64) for i in range(clients)}
    return c["X"], c["y"], tr, te, va


# ---------------------------------------------------------- reason table


def test_reasons_equal_reference():
    from neuroimagedisttraining_tpu.engines import program as jprog
    from neuroimagedisttraining_tpu_torch.engines import program

    assert program.REASONS == jprog.REASONS
    for key in program.REASONS:
        assert program.reason(key) == jprog.reason(key)


def test_report_fallback_logs_and_counts(caplog):
    from neuroimagedisttraining_tpu_torch.engines import program

    before = dict(program.FALLBACKS)
    with caplog.at_level(logging.INFO):
        msg = program.report_fallback("fedavg", "one-device",
                                      "client_mesh=%d requested", 1)
    assert msg == program.REASONS["one-device"][1]
    assert program.FALLBACKS[("sharding", "fedavg", "one-device")] == \
        before.get(("sharding", "fedavg", "one-device"), 0) + 1
    assert f"client_mesh=1 requested: {msg}" in caplog.text
    with pytest.raises(KeyError):
        program.report_fallback("fedavg", "no-such-key", "x")


# ------------------------------------------- engines built on both sides

MODES = {
    "resident": dict(mesh=4),
    "streamed": dict(mesh=4, stream=True),
    "wire_codec": dict(mesh=4, fed=dict(wire_codec="delta+sparse+quant")),
    "secure_quant": dict(mesh=4, fed=dict(secure_quant=True,
                                          secure_quant_field_bits=32)),
    "replacement": dict(mesh=4, optim=dict(batch_order="replacement")),
    "one_device": dict(mesh=1),
    "two_level": dict(mesh=(2, 2)),
    "not_tiling": dict(mesh=2, clients=3, unpadded=True),
}


def _build_pair(name: str, mode: dict, fed_extra=None, logger_dir=None):
    """``(reference engine or the ValueError it raised, port engine or
    its ValueError)`` on one configuration."""
    from neuroimagedisttraining_tpu.config import (
        DataConfig as JData, ExperimentConfig as JExp, FedConfig as JFed,
        OptimConfig as JOptim,
    )
    from neuroimagedisttraining_tpu.core.trainer import (
        LocalTrainer as JTrainer,
    )
    from neuroimagedisttraining_tpu.data.federate import (
        build_federated_data as jbuild,
    )
    from neuroimagedisttraining_tpu.data.stream import (
        StreamingFederation as JStream,
    )
    from neuroimagedisttraining_tpu.engines import create_engine as jcreate
    from neuroimagedisttraining_tpu.models import create_model as jmodel
    from neuroimagedisttraining_tpu.parallel.mesh import make_mesh as jmesh
    from neuroimagedisttraining_tpu.utils.logging import ExperimentLogger
    from neuroimagedisttraining_tpu_torch.config import (
        DataConfig, ExperimentConfig, FedConfig, OptimConfig,
    )
    from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
    from neuroimagedisttraining_tpu_torch.data.federate import (
        build_federated_data,
    )
    from neuroimagedisttraining_tpu_torch.data.stream import (
        StreamingFederation,
    )
    from neuroimagedisttraining_tpu_torch.engines import create_engine
    from neuroimagedisttraining_tpu_torch.models import create_model
    from neuroimagedisttraining_tpu_torch.parallel.mesh import (
        make_mesh, virtual_devices,
    )

    clients = mode.get("clients", 4)
    X, y, tr, te, va = _maps(clients)
    shape = mode["mesh"] if isinstance(mode["mesh"], tuple) else ()
    size = int(np.prod(mode["mesh"]))
    jm = (jmesh(shape=shape) if shape else jmesh(num_devices=size))
    pm = make_mesh(shape=shape, devices=virtual_devices(8, CPU)) if shape \
        else make_mesh(num_devices=size, devices=virtual_devices(8, CPU))
    fed = dict(client_num_in_total=clients, comm_round=3, frac=0.75,
               rounds_per_dispatch=3, client_mesh=size)
    fed.update(mode.get("fed", {}), **(fed_extra or {}))
    optim = dict(batch_size=2, epochs=1, **mode.get("optim", {}))
    jcfg = JExp(model=MODEL, algorithm=name, data=JData(dataset="synthetic"),
                optim=JOptim(**optim), fed=JFed(**fed))
    pcfg = ExperimentConfig(model=MODEL, algorithm=name,
                            data=DataConfig(dataset="synthetic",
                                            synthetic_shape=SHAPE),
                            optim=OptimConfig(**optim), fed=FedConfig(**fed))
    stream = mode.get("stream", False)
    pad_mesh = None if mode.get("unpadded") else jm
    jfed = None if stream else jbuild(X, y, tr, te, mesh=pad_mesh,
                                      val_map=va)
    pfed = None if stream else build_federated_data(
        X, y, tr, te, CPU, val_map=va,
        mesh_size=1 if mode.get("unpadded") else size)
    jstream = JStream(X, y, tr, te, val_map=va) if stream else None
    pstream = (StreamingFederation(X, y, tr, te, val_map=va, device="cpu")
               if stream else None)
    out = []
    try:
        jt = JTrainer(jmodel(MODEL, num_classes=1, remat=False), jcfg.optim,
                      num_classes=1)
        out.append(jcreate(name, jcfg, jfed, jt, mesh=jm,
                           logger=ExperimentLogger(logger_dir, "synthetic",
                                                   jcfg.identity(),
                                                   console=False),
                           stream=jstream))
    except ValueError as e:
        out.append(e)
    try:
        pt = LocalTrainer(create_model(MODEL, SHAPE), pcfg.optim, CPU,
                          torch.Generator().manual_seed(0))
        out.append(create_engine(name, pcfg, pfed, pt, stream=pstream,
                                 mesh=pm))
    except ValueError as e:
        out.append(e)
    if pstream is not None:
        pstream.close()
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", NAMES)
def test_fallback_keys_equal_reference(name, mode, tmp_path):
    jeng, peng = _build_pair(name, MODES[mode], logger_dir=str(tmp_path))
    assert isinstance(jeng, ValueError) == isinstance(peng, ValueError), (
        jeng, peng)
    if isinstance(jeng, ValueError):
        return
    assert peng.fused_fallback_key() == jeng.fused_fallback_key()
    assert peng.program.cohort_fallback_key() == \
        jeng.program.cohort_fallback_key()
    assert peng._cohort_on == jeng._cohort_on


# ------------------------------------------------------------- the planner


def test_dispatch_window_grid_equals_reference(tmp_path):
    jeng, peng = _build_pair("fedavg", MODES["resident"],
                             logger_dir=str(tmp_path))
    jbase, pbase = jeng.cfg, peng.cfg
    for K in (1, 2, 3, 4, 8):
        for freq in (1, 2, 3, 5):
            for rounds in (1, 4, 7, 10):
                kw = dict(rounds_per_dispatch=K, frequency_of_the_test=freq,
                          comm_round=rounds)
                jeng.cfg = dataclasses.replace(
                    jbase, fed=dataclasses.replace(jbase.fed, **kw))
                peng.cfg = dataclasses.replace(
                    pbase, fed=dataclasses.replace(pbase.fed, **kw))
                want = [jeng.program.dispatch_window(r)
                        for r in range(rounds)]
                assert [peng.program.dispatch_window(r)
                        for r in range(rounds)] == want, kw


def test_dispatch_window_pins_dpsgd_finetune(tmp_path):
    jeng, peng = _build_pair("dpsgd", MODES["resident"],
                             fed_extra=dict(comm_round=230,
                                            frequency_of_the_test=50,
                                            rounds_per_dispatch=8),
                             logger_dir=str(tmp_path))
    want = [jeng.program.dispatch_window(r) for r in range(230)]
    assert [peng.program.dispatch_window(r) for r in range(230)] == want
    assert peng.program.dispatch_window(96) == 4  # ends at round 99


def test_window_sampling_shrinks_under_crashes(tmp_path):
    jeng, peng = _build_pair(
        "fedavg", MODES["resident"],
        fed_extra=dict(fault_spec="crash:2@2,crash:4@5", comm_round=9,
                       frac=1.0, rounds_per_dispatch=8),
        logger_dir=str(tmp_path))
    for r in range(8):
        for k in (1, 3, 8):
            k = min(k, 9 - r)
            js, jk = jeng.program.window_sampling(r, k)
            ps, pk = peng.program.window_sampling(r, k)
            assert pk == jk
            assert [x.tolist() for x in ps] == [np.asarray(x).tolist()
                                               for x in js]
    assert peng.program.window_sampling(0, 4)[1] == 2


# ----------------------------------------------------- windows on the CPU


def _port_engine(name: str, K: int, tmp=None, streamed=False,
                 virtual_devices: int = 0, **fed):
    from neuroimagedisttraining_tpu_torch.__main__ import build_experiment
    from neuroimagedisttraining_tpu_torch.config import (
        DataConfig, ExperimentConfig, FedConfig, OptimConfig,
    )

    f = dict(client_num_in_total=4, comm_round=5, frequency_of_the_test=5,
             frac=0.75, rounds_per_dispatch=K)
    if name == "dpsgd":
        f["frac"] = 0.5
    f.update(fed)
    optim = dict(batch_size=4, epochs=2 if name == "subavg" else 1)
    cfg = ExperimentConfig(
        model=MODEL, algorithm=name,
        data=DataConfig(dataset="synthetic", synthetic_shape=SHAPE,
                        synthetic_num_subjects=32),
        optim=OptimConfig(**optim), fed=FedConfig(**f),
        stream_chunk_clients=2, virtual_devices=virtual_devices)
    if name == "subavg":
        import neuroimagedisttraining_tpu_torch.config as C
        cfg = dataclasses.replace(cfg, sparsity=C.SparsityConfig(
            dist_thresh=0.0, acc_thresh=0.0))
    eng, _ = build_experiment(cfg, "cpu", streaming=streamed)
    return eng


def _final_state(res):
    for k in ("params", "personal_params", "global_params"):
        if k in res:
            v = res[k]
            return v if isinstance(v, dict) else {
                f"{i}.{n}": t for i, d in enumerate(v) for n, t in d.items()}
    raise KeyError(list(res))


def _losses(res):
    return [h["train_loss"] for h in res["history"]]


@pytest.mark.parametrize("name", FUSING)
def test_window_is_bit_for_bit_single_rounds(name, caplog):
    with torch_threads(2):
        single = _port_engine(name, 1)
        reads = []
        single_read = single.read_host
        single.read_host = lambda v: (reads.append(len(v)),
                                      single_read(v))[1]
        r1 = single.train()
        win = _port_engine(name, 3)
        wreads = []
        win_read = win.read_host
        win.read_host = lambda v: (wreads.append(len(v)), win_read(v))[1]
        with caplog.at_level(logging.INFO):
            r3 = win.train()
    s1, s3 = _final_state(r1), _final_state(r3)
    assert s1.keys() == s3.keys()
    for k in s1:
        assert torch.equal(s1[k], s3[k]), k
    assert _losses(r1) == _losses(r3)
    # round 0 and 4 are hooked (evaluation, the last round): windows
    # [0], [1, 3], [4]; one host read a window against one a round
    assert len(reads) == 5 and len(wreads) == 3
    per_round = reads[0]
    assert wreads == [per_round, 3 * per_round, per_round]
    lines = [r.getMessage() for r in caplog.records
             if "fused window of 3" in r.getMessage()]
    assert [int(m.split()[2].rstrip(":")) for m in lines] == [1, 2, 3]
    # the static-buffer steps: per configuration the first step runs
    # eagerly, the second is "captured", every later one "replayed"
    # in every round, windowed or not: the same steps, so the same counts
    built, dispatches = win.program.built, win.program.dispatches
    assert built >= 1 and dispatches >= 1
    assert (single.program.built, single.program.dispatches) == (
        built, dispatches)


def test_streamed_window_equals_resident_window():
    with torch_threads(2):
        res = _port_engine("fedavg", 3, comm_round=6).train()
        eng = _port_engine("fedavg", 3, streamed=True, comm_round=6)
        assert eng.fused_fallback_key() is None
        calls = []
        get = eng.stream.get_window
        eng.stream.get_window = lambda ids, n_real=None: (
            calls.append(len(ids)), get(ids, n_real))[1]
        st = eng.train()
        eng.stream.close()
    assert calls == [3, 2]   # windows [1, 3] and [4, 5]
    for k in res["params"]:
        assert torch.equal(res["params"][k], st["params"][k]), k
    assert _losses(res) == _losses(st)


def test_streamed_salientgrads_runs_single_rounds(caplog):
    with torch_threads(2), caplog.at_level(logging.INFO):
        eng = _port_engine("salientgrads", 3, streamed=True)
        eng.stream.close()
    assert eng.fused_fallback_key() == "streaming-host-data"
    assert "rounds_per_dispatch=3 requested; dispatching one round at a " \
           "time: streaming rounds cross the host" in caplog.text


# ------------------------------------ against the reference's fused window

PAIR_FED = dict(client_num_in_total=4, comm_round=5, frequency_of_the_test=5,
                frac=0.75, rounds_per_dispatch=3)


@pytest.mark.parametrize("name", ["fedavg", "salientgrads"])
def test_window_matches_reference_fused_window(name, tmp_path):
    X, y, tr, te, _ = _maps()
    with torch_threads(2):
        jres, pres, jeng, peng, init = run_engine_pair(
            name, (X, y, tr, te), dict(batch_size=2, epochs=1),
            PAIR_FED, tmp_path, shape=SHAPE, model=MODEL)
    assert jeng.fused_fallback_reason() is None
    assert jeng.program.built >= 1  # the reference ran a fused window
    assert peng.fused_fallback_key() is None
    assert peng.program.built >= 1
    assert_state_close(pres["params"], pres["batch_stats"], jres["params"],
                       jres["batch_stats"], init[0], **TRAJECTORY)
    jl = [h["train_loss"] for h in jres["history"]]
    np.testing.assert_allclose([h["train_loss"] for h in pres["history"]
                                if h["round"] in (0, 4)],
                               [float(x) for x in jl], rtol=LOSS_RTOL)


# ------------------------------------------------------------------ CLI

ARGV = [
    [],
    ["--rounds_per_dispatch", "4"],
    ["--client_mesh", "2", "--virtual_devices", "2"],
    ["--mesh_shape", "2", "4"],
    ["--mesh_shape", "3"],
    ["--neighbor_num", "3", "--cs", "ring"],
]


@pytest.mark.parametrize("argv", ARGV)
def test_new_flags_parse_as_reference(argv):
    import argparse

    from neuroimagedisttraining_tpu import __main__ as jmain
    from neuroimagedisttraining_tpu_torch.__main__ import (
        add_args, config_from_args,
    )

    jargs = jmain.add_args(argparse.ArgumentParser()).parse_args(argv)
    pargs = add_args(argparse.ArgumentParser()).parse_args(argv)
    for k in ("rounds_per_dispatch", "client_mesh", "mesh_shape",
              "virtual_devices", "neighbor_num"):
        assert getattr(pargs, k) == getattr(jargs, k), k
    jc, pc = jmain.config_from_args(jargs), config_from_args(pargs)
    for k in ("rounds_per_dispatch", "client_mesh", "neighbor_num"):
        assert getattr(pc.fed, k) == getattr(jc.fed, k), k
    assert pc.mesh_shape == jc.mesh_shape


def test_client_mesh_mismatch_errors_carry_reference_messages(tmp_path):
    for mode, fed in ((dict(mesh=4), dict(client_mesh=2)),):
        jeng, peng = _build_pair("fedavg", mode, fed_extra=fed,
                                 logger_dir=str(tmp_path))
        assert isinstance(jeng, ValueError) and isinstance(peng, ValueError)
        assert str(peng) == str(jeng)
    from neuroimagedisttraining_tpu_torch.engines import create_engine

    eng = _build_pair("fedavg", MODES["resident"],
                      logger_dir=str(tmp_path))[1]
    cfg = dataclasses.replace(eng.cfg, fed=dataclasses.replace(
        eng.cfg.fed, client_mesh=3))
    with pytest.raises(ValueError, match="--client_mesh 3 requested but no "
                       "device mesh was constructed"):
        create_engine("fedavg", cfg, eng.data, eng.trainer)


def test_client_mesh_one_logs_one_device(caplog):
    with torch_threads(2), caplog.at_level(logging.INFO):
        eng = _port_engine("fedavg", 1, client_mesh=1)
    assert not eng._cohort_on
    assert ("client_mesh=1 requested; running the unsharded round "
            "program: only one device visible") in caplog.text


def _eager_local_train(t, params, bstats, X, y, n_valid, lr, epochs,
                       batch_size, max_samples, mask=None, prox_lamda=None,
                       prox_ref=None, momentum=None):
    """``LocalTrainer.local_train``'s steps one after the other on fresh
    tensors, with no static buffers: the trainer's own loss, gradient,
    optimizer step and proximal pull, its generator's draws in the same
    order."""
    from neuroimagedisttraining_tpu_torch.core.optim import AdamState
    from neuroimagedisttraining_tpu_torch.core.trainer import (
        epoch_permutations, prox_pull_,
    )

    steps = math.ceil(n_valid / batch_size)
    shuffle = t.optim_cfg.batch_order == "shuffle"
    perms = (epoch_permutations(t.generator, epochs, max_samples, n_valid,
                                t.device) if shuffle else None)
    p = {k: v.detach().clone() for k, v in params.items()}
    b = {k: v.clone() for k, v in bstats.items()}
    names = list(p)
    p_list = [p[k] for k in names]
    m_list = [mask[k] for k in names] if mask is not None else None
    ref_list = ([prox_ref[k] for k in names] if prox_lamda is not None
                else None)
    if momentum is None:
        trace = t.opt.init(p_list)
    elif isinstance(momentum, AdamState):
        trace = AdamState([momentum.mu[k] for k in names],
                          [momentum.nu[k] for k in names], momentum.count)
    else:
        trace = [momentum[k] for k in names]
    loss_sum = torch.zeros((), dtype=torch.float32)
    offsets = torch.arange(batch_size)
    for e in range(epochs):
        for s in range(steps):
            if shuffle:
                pos = s * batch_size + offsets
                idx = perms[e][pos % max(n_valid, 1)]
                w = (pos < n_valid).to(torch.float32)
            else:
                idx = torch.randint(0, max(n_valid, 1), (batch_size,),
                                    generator=t.generator)
                w = None
            loss, grads, b = t.loss_and_grad(p, b, X[idx], y[idx], w)
            t.opt.step(p_list, [grads[k] for k in names], trace, lr, m_list)
            if prox_lamda is not None:
                prox_pull_(p_list, ref_list, lr, prox_lamda)
            loss_sum = loss_sum + loss
    if isinstance(momentum, AdamState):
        momentum.count = trace.count
    return p, b, loss_sum / max(epochs * steps, 1)


@pytest.mark.parametrize("optim", [
    dict(), dict(fused_update=True), dict(client_optimizer="adam"),
    dict(batch_order="replacement"), dict(momentum=0.0)])
@pytest.mark.parametrize("prox", [False, True])
def test_graphed_local_train_is_the_eager_one(optim, prox):
    """``local_train``'s static-buffer steps (``core/graphs.py``) against
    eager steps (:func:`_eager_local_train`), bit for bit, over three
    clients of different row counts under a mask, with and without the
    proximal pull, the third client carrying a caller's optimizer state
    (Sub-FedAvg's split), in every optimizer configuration; one step
    configuration "captured" and the later steps "replayed"."""
    from neuroimagedisttraining_tpu_torch.config import OptimConfig
    from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
    from neuroimagedisttraining_tpu_torch.models import create_model

    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.integers(0, 255, (8, *SHAPE), dtype=np.uint8))
    y = torch.tensor([0, 1] * 4, dtype=torch.int32)
    model = create_model(MODEL, SHAPE)
    model.reset_parameters(torch.Generator().manual_seed(1))
    p = {k: v.detach().clone() for k, v in model.named_parameters()}
    b = {k: v.clone() for k, v in model.named_buffers()}
    mask = {k: (torch.rand(v.shape, generator=torch.Generator().manual_seed(
        2)) < 0.7).float() for k, v in p.items()}
    runs = []
    for graphed in (False, True):
        t = LocalTrainer(create_model(MODEL, SHAPE),
                         OptimConfig(batch_size=3, **optim), CPU,
                         torch.Generator().manual_seed(0))
        train = (t.local_train if graphed
                 else functools.partial(_eager_local_train, t))
        out = []
        for c in range(3):
            kw = dict(prox_lamda=0.5, prox_ref=p) if prox else {}
            mom = t.init_momentum(p) if c == 2 else None
            out.append(train(p, b, X, y, 7 - c, torch.tensor(0.05), 2, 3, 8,
                             mask=mask, momentum=mom, **kw))
            if mom is not None:
                out.append((mom.mu if optim.get("client_optimizer")
                            else mom or {}, {}, torch.zeros(())))
        runs.append(out)
        assert t.graph_stats == ((1, 13) if graphed else (0, 0))
    for (pa, ba, la), (pb, bb, lb) in zip(*runs):
        assert torch.equal(la, lb)
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k
        for k in ba:
            assert torch.equal(ba[k], bb[k]), k
