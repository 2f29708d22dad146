"""``--secure_quant`` through the engines: the GF(p) fold that replaces the
round's tail, against the reference package's jitted stage
(``engines/program.py`` ``secure_quant_aggregate``) and the port's host
protocol bit for bit; FedAvg, FedProx, Ditto and SalientGrads (under the
reference's phase-1 mask) with the flag, and FedAvg under a nonfinite
attack with ``norm_diff_clipping``, each run by the reference's engine and
the port's on the same cohort, weights, epoch permutations and dropout
masks (``torch_port_support.run_engine_pair``: Tiny3DCNN at 12x14x12 with
5 site clients, batch 2, 2 rounds of 1 epoch, ``--secure_quant_field_bits
32``); TurboAggregate, which keeps its own share stage, unchanged by the
flag on both sides; a streamed run equal to its resident one; and the
startup and CLI refusals against the reference's messages.

Tolerance of the pairs: ``TRAJECTORY`` plus one lattice step
(``2^-frac_bits`` times the leaf's scale) an entry, since a rounding-level
difference of an upload may move its quantized value by one unit; round
losses at ``LOSS_RTOL``; the non-finite counts and the privacy ledger
exactly."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.data.synthetic import generate_synthetic_abcd
from neuroimagedisttraining_tpu_torch.weights import params_from_flax

from torch_port_support import (
    LOSS_RTOL, TRAJECTORY, run_engine_pair, torch_threads,
)

MODEL, SHAPE = "3dcnn_tiny", (12, 14, 12)
OPTIM = dict(batch_size=2, epochs=1, fused_update=True)
SQ = dict(secure_quant=True, secure_quant_field_bits=32)
FED = dict(client_num_in_total=5, comm_round=2, frequency_of_the_test=1,
           **SQ)
CASES = {
    "fedavg": ("fedavg", {}),
    "fedprox": ("fedprox", {}),
    "ditto": ("ditto", {}),
    "salientgrads": ("salientgrads", {}),
    "clip_nonfinite": ("fedavg", dict(fault_spec="byz:2@0:nonfinite",
                                      defense_type="norm_diff_clipping",
                                      norm_bound=0.02)),
}


def _cohort():
    c = generate_synthetic_abcd(num_subjects=25, shape=SHAPE, num_sites=5,
                                seed=3)
    rows = np.arange(25).reshape(5, 5)
    train_map = {i: rows[i, :3].astype(np.int64) for i in range(5)}
    test_map = {i: rows[i, 3:].astype(np.int64) for i in range(5)}
    return c["X"], c["y"], train_map, test_map


# ------------------------------------------------------------ the fold stage

def _stacks():
    """The reference's own stacks (its test of the stage): C = 5 clients, a
    BatchNorm-magnitude leaf and a NaN row."""
    rng = np.random.default_rng(7)
    C = 5
    upload = {
        "params": {
            "k": (3.0 * rng.standard_normal((C, 3, 4))).astype(np.float32),
            "b": rng.standard_normal((C, 7)).astype(np.float32)},
        "batch_stats": {
            "m": (40.0 * rng.standard_normal((C, 6))).astype(np.float32)}}
    upload["params"]["b"][2, 3] = np.nan
    ref = {
        "params": {"k": rng.standard_normal((3, 4)).astype(np.float32),
                   "b": rng.standard_normal(7).astype(np.float32)},
        "batch_stats": {
            "m": (50.0 * rng.standard_normal(6)).astype(np.float32)}}
    w = np.asarray([8.0, 11.0, 9.0, 12.0, 10.0], np.float32)
    losses = np.asarray([0.5, 0.6, np.nan, 0.7, 0.55], np.float32)
    return upload, ref, w, losses


def _host_fold(uploads, like, w, spec, scales, shift):
    """The port's host protocol: integer weights from the float32 formula,
    every client's ``encode_secure_quant`` frame (its own generator)
    folded through a ``SlotAccumulator``, finalized, over the integer
    mass in float32."""
    from neuroimagedisttraining_tpu_torch.privacy import (
        SlotAccumulator, encode_secure_quant,
    )

    w = np.asarray(w, np.float32)
    wn = w / np.float32(np.max(w))
    wi = np.maximum(np.rint(wn * np.float32(1 << shift)),
                    np.float32(1.0)).astype(np.int64)
    denom = np.float32(wi.sum())
    acc = SlotAccumulator(spec, like=like)
    for c, u in enumerate(uploads):
        acc.fold(encode_secure_quant(u, 1.0, spec,
                                     np.random.default_rng(1000 + c),
                                     scales=scales), weight_int=int(wi[c]))
    host = acc.finalize(like=like, rescale=1.0, scales=scales)
    return {k: (np.asarray(v, np.float32) / denom).astype(v.dtype)
            for k, v in host.items()}


@pytest.mark.parametrize("frac_bits,shift", [(10, 6), (16, 6), (10, 3)])
def test_fold_stage_bitwise_against_reference_and_host(frac_bits, shift):
    """The port's fold (the engine's ``secure_quant_aggregate`` on CPU
    tensors) equals the reference's jitted stage and the port's host fold
    over masked frames in every bit, NaN row included; ``n_bad`` counts
    the NaN row (it gates nothing) and the mean loss is the reference's."""
    from neuroimagedisttraining_tpu.engines import program as round_program
    from neuroimagedisttraining_tpu.privacy import (
        QuantSpec as JSpec, leaf_scales as jleaf_scales,
    )
    from neuroimagedisttraining_tpu_torch.engines.base import (
        FederatedEngine,
    )
    from neuroimagedisttraining_tpu_torch.privacy import (
        QuantSpec, leaf_scales,
    )

    upload, ref, w, losses = _stacks()
    jspec, spec = JSpec.from_bits(32, frac_bits), QuantSpec.from_bits(
        32, frac_bits)
    jscales = jleaf_scales(ref)
    jeng = types.SimpleNamespace(
        cfg=types.SimpleNamespace(fed=types.SimpleNamespace(
            defense_type="none")),
        sq_spec=jspec, sq_scales=jscales, sq_weight_shift=shift)
    jp, jb, jloss, jbad = jax.jit(
        lambda u, rf, ww, ls: round_program.secure_quant_aggregate(
            jeng, u, rf, ww, ls))(upload, ref, jnp.asarray(w),
                                  jnp.asarray(losses))
    want = {f"params/{k}": np.asarray(v) for k, v in jp.items()}
    want.update({f"batch_stats/{k}": np.asarray(v) for k, v in jb.items()})

    names = {"params": ["params/b", "params/k"],
             "batch_stats": ["batch_stats/m"]}
    like = {n: ref[n.split("/")[0]][n.split("/")[1]]
            for ns in names.values() for n in ns}
    scales = leaf_scales(like)
    assert scales == {n: jscales[n] for n in scales}
    assert scales["batch_stats/m"] > 1.0
    uploads = [{n: upload[n.split("/")[0]][n.split("/")[1]][c] for n in like}
               for c in range(5)]
    peng = types.SimpleNamespace(
        cfg=types.SimpleNamespace(fed=types.SimpleNamespace(
            defense_type="none")),
        sq_spec=spec, sq_scales=scales, sq_weight_shift=shift)
    t = [{n: torch.from_numpy(u[n]) for n in like} for u in uploads]
    p, b, loss, n_bad = FederatedEngine.secure_quant_aggregate(
        peng, 0, list(range(5)), [{n: u[n] for n in names["params"]}
                                  for u in t],
        [{n: u[n] for n in names["batch_stats"]} for u in t],
        {n: torch.from_numpy(like[n]) for n in names["params"]},
        torch.from_numpy(w), torch.from_numpy(losses))
    got = {**p, **b}
    host = _host_fold(uploads, like, w, spec, scales, shift)
    for n in like:
        assert got[n].dtype == torch.float32
        assert got[n].numpy().tobytes() == want[n].tobytes(), n
        assert host[n].tobytes() == want[n].tobytes(), n
        assert np.isfinite(want[n]).all()
    assert int(n_bad) == int(jbad) == 1
    assert loss.numpy().tobytes() == np.asarray(jloss).tobytes()


def test_fold_is_within_a_lattice_step_of_the_mean():
    """On finite uploads the fold is the plain weighted mean up to one
    lattice step (``2^-frac_bits`` times the leaf's scale) an entry."""
    from neuroimagedisttraining_tpu_torch.core import robust
    from neuroimagedisttraining_tpu_torch.ops import mpc_device
    from neuroimagedisttraining_tpu_torch.privacy import leaf_scales

    upload, ref, w, _ = _stacks()
    upload["params"]["b"][2, 3] = 0.5
    uploads = [{f"{g}/{k}": torch.from_numpy(v[c])
                for g in upload for k, v in upload[g].items()}
               for c in range(5)]
    scales = leaf_scales({f"{g}/{k}": v for g in ref
                          for k, v in ref[g].items()})
    wt = torch.from_numpy(w)
    got = mpc_device.secure_quant_fold(uploads, wt, 2**31 - 1, 10, 6,
                                       scales)
    wi = mpc_device.sq_integer_weights(wt, 6)
    plain = robust.weighted_mean(uploads, wi)
    for k, v in got.items():
        err = float((v - plain[k]).abs().max())
        assert err <= scales[k] * 2.0 ** -10, (k, err)


# ------------------------------------------------------------- engine pairs

_RUNS: dict = {}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """``pair(case)``: the reference result, port result, reference
    engine, port engine and initial state, run once a case."""
    mp = pytest.MonkeyPatch()
    mp.setenv("NIDT_FAST_STEM", "1")

    def get(case):
        if case not in _RUNS:
            name, fed = CASES[case]
            with torch_threads(2):
                _RUNS[case] = run_engine_pair(
                    name, _cohort(), OPTIM, dict(FED, **fed),
                    tmp_path_factory.mktemp(case), shape=SHAPE, model=MODEL)
        return _RUNS[case]

    try:
        yield get
    finally:
        mp.undo()


def _assert_state_within_lattice(got_p, got_b, ref_p, ref_b, init_p, peng):
    """``TRAJECTORY`` plus one lattice step of the leaf an entry
    (``ref_b`` None: the weights alone, as the reference's Ditto returns
    no global statistics)."""
    ref_p, ref_b = params_from_flax(jax.tree.map(np.asarray, ref_p),
                                    jax.tree.map(np.asarray, ref_b or {}))
    step = {k: s * 2.0 ** -peng.sq_spec.frac_bits
            for k, s in peng.sq_scales.items()}
    moved = max(float((v - init_p[k]).abs().max()) for k, v in ref_p.items())
    assert moved > 0
    for k, v in ref_p.items():
        np.testing.assert_allclose(
            got_p[k].numpy(), v.numpy(), rtol=0,
            atol=TRAJECTORY["atol_moved"] * moved + step[k], err_msg=k)
    for k, v in ref_b.items():
        atol = max(1e-5, TRAJECTORY["bn_atol_max"] * float(v.abs().max()))
        np.testing.assert_allclose(got_b[k].numpy(), v.numpy(),
                                   rtol=TRAJECTORY["bn_rtol"],
                                   atol=atol + step[k], err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_round_losses_and_global_state_match(pair, case):
    """Every round's loss and the final global model, through the fold on
    both sides."""
    jres, pres, jeng, peng, (init_p, _) = pair(case)
    assert jeng.sq_spec is not None and peng.sq_spec.p == jeng.sq_spec.p
    assert peng.sq_weight_shift == jeng.sq_weight_shift == 6
    assert [h["round"] for h in pres["history"]] == \
        [h["round"] for h in jres["history"]]
    for got, ref in zip(pres["history"], jres["history"]):
        assert got["train_loss"] == pytest.approx(ref["train_loss"],
                                                  rel=LOSS_RTOL)
    _assert_state_within_lattice(pres["params"], pres["batch_stats"],
                                 jres["params"], jres.get("batch_stats"),
                                 init_p, peng)


@pytest.mark.parametrize("case", list(CASES))
def test_stat_info_matches(pair, case):
    """The non-finite count (a NaN row is counted, not dropped) exactly,
    and no privacy ledger or codec bytes where the reference has none."""
    _, _, jeng, peng, _ = pair(case)
    ref, got = jeng.stat_info, peng.stat_info
    assert got["nonfinite_uploads"] == ref["nonfinite_uploads"]
    # byz:2@0 makes client 1 Byzantine from round 0 on: one row a round
    assert got["nonfinite_uploads"] == (2 if case == "clip_nonfinite"
                                        else 0)
    for key in ("weak_dp", "dp"):
        assert (key in got) == (key in ref)
    assert got["sum_comm_bytes"] == ref["sum_comm_bytes"] == 0


def test_scales_and_finite_aggregate_under_a_nan_row(pair):
    """The leaf scales of the initial model are the reference's, leaf for
    leaf under its flax names, and the NaN row folds as the zero residue:
    the aggregate stays finite."""
    from neuroimagedisttraining_tpu_torch.weights import flax_named_leaves

    _, pres, jeng, peng, _ = pair("clip_nonfinite")
    model = peng.trainer.model
    named = flax_named_leaves(
        {k: torch.full_like(v, peng.sq_scales[k])
         for k, v in model.named_parameters()},
        {k: torch.full_like(v, peng.sq_scales[k])
         for k, v in model.named_buffers()})
    assert {k: float(v.reshape(-1)[0]) for k, v in named.items()} == \
        jeng.sq_scales
    for st in (pres["params"], pres["batch_stats"]):
        assert all(bool(torch.isfinite(v).all()) for v in st.values())


def test_salientgrads_aggregate_keeps_the_mask_zeros(pair):
    _, pres, _, _, _ = pair("salientgrads")
    for k, m in pres["masks"].items():
        assert (pres["params"][k][m == 0] == 0).all(), k


# ------------------------------------------------------------ TurboAggregate

def _port_engine(name, fed, optim=None, stream=False):
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

    X, y, tr, te = _cohort()
    cfg = ExperimentConfig(model=MODEL, algorithm=name,
                           stream_chunk_clients=2 if stream else 0,
                           data=DataConfig(dataset="synthetic",
                                           synthetic_shape=SHAPE),
                           optim=OptimConfig(**(optim or OPTIM)),
                           fed=FedConfig(**fed))
    cpu = torch.device("cpu")
    trainer = LocalTrainer(create_model(MODEL, SHAPE), cfg.optim, cpu,
                           torch.Generator().manual_seed(0))
    if stream:
        return create_engine(name, cfg, None, trainer,
                             stream=StreamingFederation(X, y, tr, te,
                                                        device="cpu"))
    return create_engine(name, cfg, build_federated_data(X, y, tr, te, cpu),
                         trainer)


def _jax_engine(name, fed, tmp_path):
    from neuroimagedisttraining_tpu.config import (
        ExperimentConfig as JExp, FedConfig as JFed, OptimConfig as JOptim,
    )
    from neuroimagedisttraining_tpu.core.trainer import (
        LocalTrainer as JTrainer,
    )
    from neuroimagedisttraining_tpu.data.federate import (
        build_federated_data as jbuild,
    )
    from neuroimagedisttraining_tpu.engines import create_engine as jcreate
    from neuroimagedisttraining_tpu.models import create_model as jmodel
    from neuroimagedisttraining_tpu.utils.logging import ExperimentLogger

    X, y, tr, te = _cohort()
    jcfg = JExp(model=MODEL, fed=JFed(**fed), optim=JOptim(**OPTIM),
                log_dir=str(tmp_path))
    return jcreate(name, jcfg, jbuild(X, y, tr, te),
                   JTrainer(jmodel(MODEL, num_classes=1), jcfg.optim,
                            num_classes=1),
                   mesh=None, logger=ExperimentLogger(
                       str(tmp_path), "synthetic", "x", console=False))


def _bits(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].numpy().tobytes() == b[k].numpy().tobytes() for k in a)


def test_turboaggregate_ignores_the_flag_on_both_sides(tmp_path,
                                                       monkeypatch):
    """TurboAggregate inherits FedAvg's flag, so ``--secure_quant`` passes
    its startup checks, but its round keeps its own share stage: with the
    flag its run is bit for bit its run without it, on both sides."""
    monkeypatch.setenv("NIDT_FAST_STEM", "1")
    fed = dict(client_num_in_total=5, comm_round=1, frac=0.6)
    with torch_threads(2):
        runs = [_port_engine("turboaggregate", dict(fed, **sq)).train()
                for sq in ({}, SQ)]
    assert _bits(runs[0]["params"], runs[1]["params"])
    assert _bits(runs[0]["batch_stats"], runs[1]["batch_stats"])
    assert runs[0]["history"][0]["train_loss"] == \
        runs[1]["history"][0]["train_loss"]
    jruns = []
    for i, sq in enumerate(({}, SQ)):
        jeng = _jax_engine("turboaggregate", dict(fed, **sq),
                           tmp_path / str(i))
        assert (jeng.sq_spec is not None) == bool(sq)
        jruns.append(jeng.train())
    for a, b in zip(jax.tree.leaves(jruns[0]["params"]),
                    jax.tree.leaves(jruns[1]["params"])):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_streamed_run_equals_resident(monkeypatch):
    """FedAvg with the flag streamed (2 clients a chunk) is bit for bit
    its resident run: the fold does not depend on where the rows came
    from."""
    monkeypatch.setenv("NIDT_FAST_STEM", "1")
    fed = dict(client_num_in_total=5, comm_round=2, frac=0.6, **SQ)
    with torch_threads(2):
        a = _port_engine("fedavg", fed).train()
        eng = _port_engine("fedavg", fed, stream=True)
        b = eng.train()
        eng.stream.close()
    assert eng.sq_spec is not None
    assert _bits(a["params"], b["params"])
    assert _bits(a["batch_stats"], b["batch_stats"])
    assert a["history"] == [{k: v for k, v in h.items()} for h in
                            b["history"]]


# ----------------------------------------------------------------- refusals

def test_engines_flag_secure_quant_as_the_reference():
    """The engines with the default aggregation tail, and so the flag:
    FedAvg, FedProx, Ditto, SalientGrads and TurboAggregate (inherited);
    the other five refuse it."""
    from neuroimagedisttraining_tpu.engines import ENGINES as JENGINES
    from neuroimagedisttraining_tpu_torch.engines import ENGINES

    assert {n: c.supports_secure_quant for n, c in ENGINES.items()} == \
        {n: JENGINES[n].supports_secure_quant for n in ENGINES}
    assert sorted({c.name for c in ENGINES.values()
                   if c.supports_secure_quant}) == [
        "ditto", "fedavg", "fedprox", "salientgrads", "turboaggregate"]


REFUSED = [
    ("dpsgd", {}),
    ("local", {}),
    ("dispfl", {}),
    ("fedavg", dict(wire_codec="delta+quant")),
    ("fedavg", dict(defense_type="trimmed_mean")),
    ("salientgrads", dict(defense_type="krum")),
    ("fedavg", dict(secure_quant_field_bits=16)),
    ("ditto", dict(secure_quant_field_bits=8)),
    ("fedavg", dict(secure_quant_frac_bits=28)),
]


@pytest.mark.parametrize("name,fed", REFUSED)
def test_startup_refusals_match_reference(name, fed, tmp_path):
    """What ``--secure_quant`` cannot run with fails at construction with
    the reference's message (cut where the reference's goes on to point at
    its cross-silo plane and architecture notes)."""
    fed = dict(client_num_in_total=5, **dict(SQ, **fed))
    with pytest.raises(ValueError) as ref:
        _jax_engine(name, fed, tmp_path)
    with pytest.raises(ValueError) as got:
        _port_engine(name, fed)
    assert str(ref.value).startswith(str(got.value))
    assert len(str(got.value)) > 60


def test_a_cohort_of_one_fits_the_16_bit_field():
    """The 16-bit default admits a cohort of one client (shift 0 still
    folds below the field's capacity of about 2 weight units)."""
    eng = _port_engine("fedavg", dict(client_num_in_total=5, frac=0.2,
                                      secure_quant=True))
    assert eng.sq_spec.p == 65521 and eng.sq_weight_shift == 0


CLI = ["--model", MODEL, "--device", "cpu", "--dataset", "synthetic",
       "--synthetic_shape", "12", "14", "12", "--synthetic_num_subjects",
       "20", "--client_num_in_total", "4", "--comm_round", "1",
       "--batch_size", "2", "--epochs", "1", "--fused_update"]


@pytest.mark.parametrize("algorithm", ["fedavg", "salientgrads"])
def test_cli_runs_through_the_fold(algorithm, capsys, monkeypatch):
    """The CLI's three flags reach the engine, and its rounds go through
    the fold (every round's tail is ``secure_quant_aggregate``)."""
    from neuroimagedisttraining_tpu_torch.__main__ import main
    from neuroimagedisttraining_tpu_torch.engines.base import (
        FederatedEngine,
    )

    monkeypatch.setenv("NIDT_FAST_STEM", "1")
    folds = []
    real = FederatedEngine.secure_quant_aggregate
    monkeypatch.setattr(FederatedEngine, "secure_quant_aggregate",
                        lambda self, *a: (folds.append(self.sq_spec),
                                          real(self, *a))[1])
    with torch_threads(2):
        assert main(CLI + ["--algorithm", algorithm, "--secure_quant",
                           "--secure_quant_field_bits", "32",
                           "--secure_quant_frac_bits", "12"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(np.isfinite(h["train_loss"]) for h in out["history"])
    assert len(folds) == 1 and folds[0].p == 2**31 - 1 \
        and folds[0].frac_bits == 12


CLI_REFUSED = [
    ["--algorithm", "dpsgd", "--secure_quant"],
    ["--algorithm", "fedavg", "--secure_quant", "--wire_codec", "delta"],
    ["--algorithm", "fedavg", "--secure_quant", "--defense", "krum"],
    ["--algorithm", "fedavg", "--secure_quant", "--secure_quant_field_bits",
     "8"],
    ["--algorithm", "fedavg", "--secure_quant", "--mpc_n_shares", "1"],
    ["--algorithm", "fedavg", "--secure_quant", "--secure_quant_field_bits",
     "12"],
]


@pytest.mark.parametrize("flags", CLI_REFUSED)
def test_cli_refusals_match_reference(flags, capsys):
    """The argparse refusals of ``--secure_quant`` with the reference
    CLI's message (up to its pointers at its architecture notes); the
    defaults are the reference's."""
    import argparse

    from neuroimagedisttraining_tpu.__main__ import main as jmain
    from neuroimagedisttraining_tpu_torch.__main__ import add_args, main

    msgs = []
    for run in (jmain, main):
        with pytest.raises(SystemExit) as e:
            run(["--dataset", "synthetic"] + flags)
        assert e.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1]
                    .split("error: ", 1)[1])
    if flags[1] == "dpsgd":
        # the first clause of the reference's names its round program
        assert msgs[0].split("; ", 1)[1] == msgs[1].split("; ", 1)[1]
    else:
        assert msgs[0].startswith(msgs[1]) and len(msgs[1]) > 40
    ns = add_args(argparse.ArgumentParser()).parse_args([])
    assert (ns.secure_quant, ns.secure_quant_field_bits,
            ns.secure_quant_frac_bits) == (False, 16, 10)
