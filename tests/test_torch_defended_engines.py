"""The defended round end to end: the reference package's engine and the
port's on the same cohort, weights, epoch permutations and dropout masks
(``torch_port_support.run_engine_pair``), Tiny3DCNN at 12x14x12 with 5
site clients, batch 2, 2 rounds of 1 epoch, the noise draws the
reference's (passed in through ``noise_for``):

- FedAvg under a plan of sign_flip, scale and nonfinite attacks with
  ``trimmed_mean``, ``krum`` and ``norm_diff_clipping``;
- FedAvg with ``--wire_codec delta+sparse+quant`` (top-k with per-client
  error feedback carried into round 1);
- SalientGrads with the same codec against its phase-1 mask (the handoff:
  no top-k select);
- FedAvg under ``weak_dp`` and a Gaussian attack, 4 of 5 clients a round
  (the accountant at q = 0.8);
- D-PSGD with ``--dp_clip`` / ``--dp_sigma`` and its ledger.

Multi-step runs are held at ``TRAJECTORY`` (a ReLU input within float32
rounding of 0 is active on one side only), round losses at ``LOSS_RTOL``;
the rejected non-finite uploads, the dense byte count and the privacy
ledgers exactly; the encoded byte count within 2% (zlib's size of int8
codes that differ where the trajectories do; the frames of equal inputs
are byte-equal, held exactly here and in test_torch_codec.py). Also a
crash spec's cohorts, the startup refusals and the CLI of each flag group
against the reference's."""

import json

import jax
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.data.synthetic import generate_synthetic_abcd
from neuroimagedisttraining_tpu.faults import adversary as jadv
from neuroimagedisttraining_tpu_torch.codec import device as codec_device
from neuroimagedisttraining_tpu_torch.weights import params_from_flax

from torch_port_support import (
    LOSS_RTOL, TRAJECTORY, assert_state_close, rng_after_local_train,
    run_engine_pair, torch_threads,
)

MODEL, SHAPE = "3dcnn_tiny", (12, 14, 12)
OPTIM = dict(batch_size=2, epochs=1, fused_update=True)
FED = dict(client_num_in_total=5, comm_round=2, frequency_of_the_test=1)
ATTACKS = "byz:2@0:sign_flip,byz:4@0:scale:3,byz:5@1:nonfinite"
CASES = {
    "trimmed_mean": ("fedavg", dict(fault_spec=ATTACKS,
                                    defense_type="trimmed_mean")),
    "krum": ("fedavg", dict(fault_spec=ATTACKS, defense_type="krum")),
    "norm_diff_clipping": ("fedavg", dict(fault_spec=ATTACKS,
                                          defense_type="norm_diff_clipping",
                                          norm_bound=0.02)),
    "codec": ("fedavg", dict(wire_codec="delta+sparse+quant")),
    "sg_codec": ("salientgrads", dict(wire_codec="delta+sparse+quant")),
    "weak_dp": ("fedavg", dict(fault_spec="byz:3@0:gauss:0.05", frac=0.8,
                               defense_type="weak_dp", norm_bound=0.05,
                               stddev=0.01)),
    "dp": ("dpsgd", dict(dp_clip=0.05, dp_sigma=0.5, frac=0.4)),
}


def _cohort():
    c = generate_synthetic_abcd(num_subjects=25, shape=SHAPE, num_sites=5,
                                seed=3)
    rows = np.arange(25).reshape(5, 5)
    train_map = {i: rows[i, :3].astype(np.int64) for i in range(5)}
    test_map = {i: rows[i, 3:].astype(np.int64) for i in range(5)}
    return c["X"], c["y"], train_map, test_map


def _leaf_noise(tree, key_of_leaf):
    """Standard normal draws shaped like each leaf of the flax ``tree``,
    leaf i's from ``key_of_leaf(i)`` in flax leaf order."""
    leaves, treedef = jax.tree.flatten(tree)
    return jax.tree.unflatten(treedef, [
        np.array(jax.random.normal(key_of_leaf(i), np.shape(x)))
        for i, x in enumerate(leaves)])


def reference_noise(jeng, epochs):
    """A port engine's ``noise_for``: the reference's draws of each
    stream. The attack: leaf i of the whole upload from fold_in(the
    rank's attack key, i); weak DP: a split of the client's rng after its
    local training over the parameter leaves; D-PSGD's DP: a split of its
    round rng folded with the DP stream."""
    from neuroimagedisttraining_tpu.engines.dpsgd import _DP_STREAM

    gs = jeng.init_global_state()
    P = jax.tree.map(np.asarray, gs.params)
    B = jax.tree.map(np.asarray, gs.batch_stats)

    def noise_for(stream, r, c, like):
        if stream == "attack":
            key = jadv.attack_keys(jeng.cfg.seed, r, np.array([c + 1]))[0]
            t = _leaf_noise({"params": P, "batch_stats": B},
                            lambda i: jax.random.fold_in(key, i))
            p, b = params_from_flax(t["params"], t["batch_stats"])
            out = {**p, **b}
        else:
            if stream == "weak_dp":
                key = rng_after_local_train(
                    jeng, jeng.per_client_rngs(r, np.array([c]))[0], epochs)
            else:
                key = jax.random.fold_in(jeng.per_client_rngs(
                    r, np.arange(jeng.num_clients))[c], _DP_STREAM)
            keys = jax.random.split(key, len(jax.tree.leaves(P)))
            out = params_from_flax(_leaf_noise(P, lambda i: keys[i]), {})[0]
        return {k: out[k] for k in like}

    return noise_for


_RUNS: dict = {}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """``pair(case)``: ``(reference result, port result, reference engine,
    port engine, initial state, top-k selects the port's codec ran)``,
    run once per case."""
    mp = pytest.MonkeyPatch()
    mp.setenv("NIDT_FAST_STEM", "1")
    selects = []
    real = codec_device.kth_largest
    mp.setattr(codec_device, "kth_largest",
               lambda x, k: selects.append(k) or real(x, k))

    def get(case):
        if case not in _RUNS:
            name, fed = CASES[case]

            def setup(jeng, peng):
                peng.noise_for = reference_noise(jeng, OPTIM["epochs"])

            del selects[:]
            with torch_threads(2):
                out = run_engine_pair(
                    name, _cohort(), OPTIM, dict(FED, **fed),
                    tmp_path_factory.mktemp(case), shape=SHAPE, model=MODEL,
                    setup=setup)
            _RUNS[case] = (*out, len(selects))
        return _RUNS[case]

    try:
        yield get
    finally:
        mp.undo()


@pytest.mark.parametrize("case", list(CASES))
def test_round_losses_and_global_state_match(pair, case):
    """Every round's loss (rtol 1e-4) and the final global model (weights
    and BN stats at ``TRAJECTORY``)."""
    jres, pres, _, _, (init_p, _), _ = pair(case)
    assert [h["round"] for h in pres["history"]] == \
        [h["round"] for h in jres["history"]]
    for got, ref in zip(pres["history"], jres["history"]):
        assert got["train_loss"] == pytest.approx(ref["train_loss"],
                                                  rel=LOSS_RTOL)
    if CASES[case][0] == "dpsgd":
        assert_state_close(pres["global_params"], pres["global_batch_stats"],
                           jres["global_params"], None, init_p, **TRAJECTORY)
    else:
        assert_state_close(pres["params"], pres["batch_stats"],
                           jres["params"], jres["batch_stats"], init_p,
                           **TRAJECTORY)


@pytest.mark.parametrize("case", list(CASES))
def test_stat_info_matches(pair, case):
    """The rejected non-finite uploads and the new keys: the dense bytes
    and the DP / weak-DP ledgers exactly, the encoded bytes within 2%."""
    _, _, jeng, peng, _, _ = pair(case)
    ref, got = jeng.stat_info, peng.stat_info
    assert got["nonfinite_uploads"] == ref["nonfinite_uploads"]
    assert got["sum_comm_bytes_dense"] == ref["sum_comm_bytes_dense"]
    assert got["sum_comm_bytes"] == pytest.approx(ref["sum_comm_bytes"],
                                                  rel=2e-2)
    for key in ("weak_dp", "dp"):
        assert (key in got) == (key in ref)
        if key in ref:
            assert got[key] == ref[key]
    if case in ("trimmed_mean", "krum", "norm_diff_clipping"):
        assert got["nonfinite_uploads"] == 1  # the nonfinite row in round 1
    if "codec" in case:
        assert 0 < got["sum_comm_bytes"] < got["sum_comm_bytes_dense"]


def test_codec_error_feedback_matches(pair):
    """FedAvg's per-client error feedback after round 1, against the
    reference's accumulators at ``TRAJECTORY``: the parameters' within its
    share of the largest parameter feedback entry, the BN statistics'
    within its share of the statistic's largest value (what a statistic's
    feedback carries is the statistic's own difference). An entry at the
    top-k threshold may be kept on one side and dropped on the other: its
    feedback is then the entry itself on one side and its quantization
    error on the other, so it differs by up to the threshold, about the
    largest feedback entry. Such entries may be at most 0.5% of a
    client's (measured: up to 5 of 4,881) and within the largest feedback
    entry (either side's) plus the tolerance. And the selects: one a
    client a round."""
    jres, _, jeng, peng, _, selects = pair("codec")
    assert selects == 5 * 2
    _, stats = params_from_flax({}, jax.tree.map(np.asarray,
                                                 jres["batch_stats"]))
    for c in range(5):
        ef = jax.tree.map(lambda x: np.asarray(x[c]), jeng._wire_ef)
        p, b = params_from_flax(ef["params"], ef["batch_stats"])
        largest = max(max(float(v.abs().max()) for v in p.values()),
                      max(float(peng._wire_ef[c][k].abs().max()) for k in p))
        ptol = TRAJECTORY["atol_moved"] * max(float(v.abs().max())
                                              for v in p.values())
        flips, total = 0, 0
        for k, v in {**p, **b}.items():
            tol = (ptol if k in p else TRAJECTORY["bn_atol_max"]
                   * float(stats[k].abs().max()))
            diff = (peng._wire_ef[c][k] - v).abs()
            if k not in p:
                assert float(diff.max()) <= tol, (c, k)
                continue
            assert float(diff.max()) <= largest + tol, (c, k)
            flips += int((diff > tol).sum())
            total += diff.numel()
        assert flips <= 5e-3 * total, (c, flips)


def test_salientgrads_codec_hands_off_the_mask(pair):
    """SalientGrads packs its uploads against the phase-1 mask: no top-k
    select runs, and the global model keeps the mask's zeros."""
    _, pres, _, peng, _, selects = pair("sg_codec")
    assert selects == 0
    for k, m in pres["masks"].items():
        assert (pres["params"][k][m == 0] == 0).all(), k


def test_crash_spec_cohorts_match_reference(tmp_path):
    """The survivors of ``crash:2@0,crash:4@1,rejoin:2@2`` (client c is
    rank c + 1) are the reference engine's cohorts, frac-sampled or not,
    and the port's FedAvg trains exactly them."""
    from neuroimagedisttraining_tpu.config import (
        ExperimentConfig as JExp, FedConfig as JFed,
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
    for frac in (1.0, 0.6):
        fed = dict(client_num_in_total=5, frac=frac, comm_round=4,
                   fault_spec="crash:2@0,crash:4@1,rejoin:2@2")
        jcfg = JExp(model=MODEL, fed=JFed(**fed), log_dir=str(tmp_path))
        jeng = jcreate("fedavg", jcfg, jbuild(X, y, tr, te),
                       JTrainer(jmodel(MODEL, num_classes=1), jcfg.optim,
                         num_classes=1),
                       mesh=None, logger=ExperimentLogger(
                           str(tmp_path), "synthetic", "x", console=False))
        peng = _port_engine("fedavg", fed)
        calls = []
        peng.client_train = lambda r, c, *a, **k: (
            calls.append((r, c)), (a[1], a[2], torch.tensor(0.5)))[1]
        peng.train()
        want = []
        for r in range(4):
            s = jeng.client_sampling(r)
            np.testing.assert_array_equal(peng.client_sampling(r), s)
            want += [(r, int(c)) for c in s]
        assert calls[:len(want)] == want
        assert (0, 1) not in want and (1, 3) not in want


def _port_engine(name, fed, optim=None):
    from neuroimagedisttraining_tpu_torch.config import (
        DataConfig, ExperimentConfig, FedConfig, OptimConfig,
    )
    from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
    from neuroimagedisttraining_tpu_torch.data.federate import (
        build_federated_data,
    )
    from neuroimagedisttraining_tpu_torch.engines import create_engine
    from neuroimagedisttraining_tpu_torch.models import create_model

    X, y, tr, te = _cohort()
    cfg = ExperimentConfig(model=MODEL, algorithm=name,
                           data=DataConfig(dataset="synthetic",
                                           synthetic_shape=SHAPE),
                           optim=OptimConfig(**(optim or OPTIM)),
                           fed=FedConfig(**fed))
    cpu = torch.device("cpu")
    return create_engine(name, cfg, build_federated_data(X, y, tr, te, cpu),
                         LocalTrainer(create_model(MODEL, SHAPE), cfg.optim,
                                      cpu, torch.Generator().manual_seed(0)))


REFUSED = [
    ("dispfl", dict(fault_spec="byz:1@0:sign_flip")),
    ("local", dict(defense_type="krum")),
    ("turboaggregate", dict(defense_type="median")),
    ("fedavg", dict(defense_type="bulyan")),
    ("fedavg", dict(defense_type="krum", byz_f=3)),
    ("fedavg", dict(defense_type="trimmed_mean", byz_f=3)),
    ("fedavg", dict(dp_sigma=1.0)),
    ("fedavg", dict(dp_clip=1.0)),
    ("dpsgd", dict(dp_clip=-1.0)),
    ("ditto", dict(wire_codec="delta+sparse")),
    ("fedavg", dict(wire_codec="delta+zip")),
    ("fedavg", dict(fault_spec="crash:x@1")),
]


@pytest.mark.parametrize("name,fed", REFUSED)
def test_startup_refusals_match_reference(name, fed, tmp_path):
    """What an engine cannot run fails at construction with the
    reference's message (the codec's ends where the reference's goes on to
    point at its cross-silo plane, which the port does not have)."""
    from neuroimagedisttraining_tpu.config import (
        ExperimentConfig as JExp, FedConfig as JFed,
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

    fed = dict(client_num_in_total=5, **fed)
    X, y, tr, te = _cohort()
    jcfg = JExp(model=MODEL, fed=JFed(**fed), log_dir=str(tmp_path))
    with pytest.raises(ValueError) as ref:
        jcreate(name, jcfg, jbuild(X, y, tr, te),
                JTrainer(jmodel(MODEL, num_classes=1), jcfg.optim,
                         num_classes=1),
                mesh=None, logger=ExperimentLogger(
                    str(tmp_path), "synthetic", "x", console=False))
    with pytest.raises(ValueError) as got:
        _port_engine(name, fed)
    if name == "ditto":
        assert str(ref.value).startswith(str(got.value) + ". Masked engines")
    else:
        assert str(got.value) == str(ref.value)


def test_preempt_refused_at_startup():
    """``preempt:`` faults are no longer refused at startup (the elastic
    mesh is ported, ``tests/test_torch_actions.py``): the engine builds,
    and with no mesh to shrink the preemption is recorded as a skipped
    ``shrink_mesh``, as the reference records it."""
    from neuroimagedisttraining_tpu_torch.obs import actions

    eng = _port_engine("fedavg", dict(client_num_in_total=5,
                                      fault_spec="preempt:1@1"))
    try:
        bus = actions.configure("dry_run")
        assert eng._maybe_preempt(0) is None
        assert eng._maybe_preempt(1) is None
    finally:
        actions.disarm()
    (e,) = bus.actions_block()["log"]
    assert e["action"] == "shrink_mesh" and e["status"] == "skipped"
    assert e["detail"] == {"reason": "no mesh to shrink",
                           "scheduled_round": 1}


CLI = ["--model", MODEL, "--device", "cpu", "--dataset", "synthetic",
       "--synthetic_shape", "12", "14", "12", "--synthetic_num_subjects",
       "20", "--client_num_in_total", "4", "--comm_round", "1",
       "--batch_size", "2", "--epochs", "1", "--fused_update"]
FLAG_GROUPS = [
    ["--algorithm", "fedavg", "--fault_spec", "byz:1@0:sign_flip,crash:4@0",
     "--defense", "median", "--byz_f", "1"],
    ["--algorithm", "fedprox", "--defense_type", "geometric_median",
     "--geomed_iters", "3", "--byz_f", "0"],
    ["--algorithm", "salientgrads", "--defense", "weak_dp", "--norm_bound",
     "1.0", "--stddev", "0.01", "--dp_delta", "1e-6"],
    ["--algorithm", "fedavg", "--wire_codec", "delta+sparse+quant16",
     "--wire_topk_ratio", "0.1"],
    ["--algorithm", "dpsgd", "--dp_clip", "1", "--dp_sigma", "1", "--frac",
     "0.5"],
]


@pytest.mark.parametrize("flags", FLAG_GROUPS,
                         ids=["faults", "geomed", "weak_dp", "codec", "dp"])
def test_cli_runs_each_flag_group(flags, capsys, monkeypatch):
    """One CLI run a flag group: the flags parse into the engine's config
    and the run ends in finite losses."""
    from neuroimagedisttraining_tpu_torch.__main__ import main

    monkeypatch.setenv("NIDT_FAST_STEM", "1")
    with torch_threads(2):
        assert main(CLI + flags) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(np.isfinite(h["train_loss"]) for h in out["history"])


CLI_REFUSED = [
    ["--algorithm", "turboaggregate", "--wire_codec", "delta"],
    ["--algorithm", "turboaggregate", "--defense", "krum"],
    ["--algorithm", "dpsgd", "--dp_sigma", "1"],
    ["--algorithm", "fedavg", "--dp_clip", "1"],
]


@pytest.mark.parametrize("flags", CLI_REFUSED)
def test_cli_refusals_match_reference(flags, capsys):
    """The privacy-plane conflicts die at argparse with the reference
    CLI's message (up to its pointers at the secure wire and the
    architecture notes, which the port does not have); the defaults are
    the reference's."""
    from neuroimagedisttraining_tpu.__main__ import main as jmain
    from neuroimagedisttraining_tpu_torch.__main__ import add_args, main

    msgs = []
    for run in (jmain, main):
        with pytest.raises(SystemExit) as e:
            run(["--dataset", "synthetic"] + flags)
        assert e.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1]
                    .split("error: ", 1)[1])
    assert msgs[0].startswith(msgs[1]) and len(msgs[1]) > 40
    import argparse

    ns = add_args(argparse.ArgumentParser()).parse_args([])
    assert (ns.defense_type, ns.norm_bound, ns.stddev, ns.byz_f,
            ns.geomed_iters, ns.dp_clip, ns.dp_sigma, ns.dp_delta,
            ns.fault_spec, ns.wire_codec, ns.wire_topk_ratio) == (
        "none", 5.0, 0.05, 1, 8, 0.0, 0.0, 1e-5, "", "none", 0.25)
