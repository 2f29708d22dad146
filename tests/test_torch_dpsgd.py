"""D-PSGD: the port's engine against the reference package's.

- The neighbour graph: ``benefit_choose`` and ``mixing_matrix`` equal to
  the reference's, bit for bit, for ``cs`` random, ring and full over 50
  rounds (numpy's global stream reseeded as the reference reseeds it).
- The whole run: both engines on the same federation, initial weights,
  epoch permutations and dropout keep-masks (Tiny3DCNN at 12x14x12:
  test_torch_flagship_engines.py holds the engine and its fine-tune
  against the reference on the flagship model at 69^3; batch 3, 1 epoch,
  2 rounds over 4 clients, ``--frac 0.5`` so each client mixes
  with 2 random others, ``--fused_update`` and ``NIDT_FAST_STEM=1``: on
  the CPU both sides take their plain paths). Several SGD steps chain, so
  personal and global states are held at ``torch_port_support.TRAJECTORY``
  and train losses at ``LOSS_RTOL``.
- The every-100-rounds fine-tune: its logic over 100 cheap rounds with a
  recording trainer (from ``w_global``, at ``round_lr(-1)``, evaluated and
  dropped), and one call on the same inputs as the reference's
  ``_finetune_jit`` at ``TRAJECTORY``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.config import (
    ExperimentConfig as JExp, FedConfig as JFed,
)
from neuroimagedisttraining_tpu.engines import ENGINES as J_ENGINES
from neuroimagedisttraining_tpu.engines import dpsgd as JD
from neuroimagedisttraining_tpu_torch.__main__ import main
from neuroimagedisttraining_tpu_torch.config import (
    DataConfig, ExperimentConfig, FedConfig, OptimConfig,
)
from neuroimagedisttraining_tpu_torch.core.optim import round_lr
from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
from neuroimagedisttraining_tpu_torch.data.federate import (
    build_federated_data,
)
from neuroimagedisttraining_tpu_torch.engines import ENGINES, create_engine
from neuroimagedisttraining_tpu_torch.engines import dpsgd as PD
from neuroimagedisttraining_tpu_torch.models import create_model
from neuroimagedisttraining_tpu_torch.ops import _cuda

from test_torch_engines import Recorder
from torch_port_support import (
    LOSS_RTOL, TRAJECTORY, assert_metrics_close, assert_state_close,
    TINY_MODEL, TINY_SHAPE, fixed_dropout, four_client_federation,
    model_dropout_masks, run_engine_pair,
    torch_threads,
)

OPTIM = dict(batch_size=3, epochs=1, fused_update=True)
FED = dict(client_num_in_total=4, frac=0.5, comm_round=2,
           frequency_of_the_test=1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``(reference result, port result, reference engine, port engine,
    initial state)``."""
    mp = pytest.MonkeyPatch()
    mp.setenv("NIDT_FAST_STEM", "1")
    try:
        with torch_threads(2):
            before = sum(_cuda.counts().values())
            out = run_engine_pair("dpsgd", four_client_federation(TINY_SHAPE),
                                  OPTIM, FED,
                                  tmp_path_factory.mktemp("dpsgd"),
                                  shape=TINY_SHAPE, model=TINY_MODEL)
            # CPU tensors: plain paths only, no kernel launched
            assert sum(_cuda.counts().values()) == before
            yield out
    finally:
        mp.undo()


def _bare(cls, fed: dict, clients: int, real: int):
    """An engine of ``cls`` with only what the neighbour graph reads."""
    eng = cls.__new__(cls)
    eng.cfg = (JExp if cls is JD.DPSGDEngine else ExperimentConfig)(
        fed=(JFed if cls is JD.DPSGDEngine else FedConfig)(**fed))
    eng.num_clients, eng.real_clients = clients, real
    return eng


@pytest.mark.parametrize("cs", ["random", "ring", "full"])
@pytest.mark.parametrize("clients,frac", [(4, 0.5), (9, 0.34), (6, 1.0)])
def test_neighbour_graph_matches_reference(cs, clients, frac):
    """``benefit_choose`` of every client and the mixing matrix of every
    round (one padding client beyond the real ones), over 50 rounds: equal
    to the reference's bit for bit."""
    fed = dict(client_num_in_total=clients, frac=frac, cs=cs)
    ref = _bare(JD.DPSGDEngine, fed, clients + 1, clients)
    port = _bare(PD.DPSGDEngine, fed, clients + 1, clients)
    per = min(ref.cfg.fed.client_num_per_round, clients)
    for r in range(50):
        for c in range(clients):
            want = JD.benefit_choose(r, c, clients, per, cs)
            got = PD.benefit_choose(r, c, clients, per, cs)
            np.testing.assert_array_equal(got, want)
        M = port.mixing_matrix(r)
        assert M.dtype == np.float32
        np.testing.assert_array_equal(M, ref.mixing_matrix(r))
        np.testing.assert_allclose(M.sum(1), 1.0, rtol=1e-6)


def test_self_is_refused():
    """``cs="self"`` is not a D-PSGD neighbour choice: ``ValueError`` in
    both packages."""
    for fn in (JD.benefit_choose, PD.benefit_choose):
        with pytest.raises(ValueError, match="unknown cs"):
            fn(0, 0, 4, 2, "self")


def test_states_match(run):
    """Every client's personal model and ``w_global`` (params and BN stats)
    at ``TRAJECTORY``."""
    jres, pres, jeng, _, (init_p, _) = run
    for c in range(jeng.num_clients):
        ref_p = jax.tree.map(lambda x: np.asarray(x)[c],
                             jres["personal_params"])
        got_b = pres["personal_batch_stats"][c]
        assert_state_close(pres["personal_params"][c], got_b, ref_p, None,
                           init_p, **TRAJECTORY)
    assert_state_close(pres["global_params"], pres["global_batch_stats"],
                       jres["global_params"], None, init_p, **TRAJECTORY)


def test_global_is_the_mean_of_the_personal_models(run):
    """``w_global`` is the plain mean of the four personal models."""
    _, pres, _, _, _ = run
    for k, v in pres["global_params"].items():
        want = torch.stack([p[k] for p in pres["personal_params"]]).mean(0)
        torch.testing.assert_close(v, want, rtol=1e-6, atol=1e-7)


def test_history_and_metrics_match(run):
    """Per round: train loss at ``LOSS_RTOL``, global and personal accuracy
    equal; the final global evaluation (``assert_metrics_close``); the
    reference's result keys and the global accuracies in ``stat_info``."""
    jres, pres, jeng, peng, _ = run
    assert set(jres) <= set(pres)
    assert len(pres["history"]) == len(jres["history"]) == 2
    for got, ref in zip(pres["history"], jres["history"]):
        assert set(got) == set(ref) and got["round"] == ref["round"]
        assert got["train_loss"] == pytest.approx(ref["train_loss"],
                                                  rel=LOSS_RTOL)
        assert got["global_acc"] == ref["global_acc"]
        assert got["personal_acc"] == ref["personal_acc"]
    assert_metrics_close(pres["final_global"], jres["final_global"])
    assert peng.stat_info["global_test_acc"] == pytest.approx(
        jeng.stat_info["global_test_acc"], abs=1e-9)
    assert len(pres["round_seconds"]) == 2


def test_finetune_matches_reference_finetune(run):
    """One fine-tune from the initial model, the same inputs on both sides
    (the reference's ``_finetune_jit`` with its round -1 keys, the port's
    permutations of round -1): every client's model (one SGD step) at
    ``TRAJECTORY``. Even one step is not held tighter: a ReLU input within
    float32 rounding of 0 flips a unit on one side (measured here: 1.6% of
    the stem BatchNorm scale's change in one element)."""
    _, _, jeng, peng, (init_p, init_b) = run
    gs = jeng.init_global_state()
    jmasks, _ = model_dropout_masks(TINY_MODEL, TINY_SHAPE,
                                    OPTIM["batch_size"], seed=1)
    with fixed_dropout(jmasks):
        ft_p, ft_b = jeng._finetune_jit(
            gs.params, gs.batch_stats, jeng.data,
            jeng.per_client_rngs(-1, np.arange(jeng.num_clients)),
            jeng.round_lr(-1))
    with torch_threads(2):
        got_p, got_b = peng.finetune(init_p, init_b)
    for c in range(jeng.num_clients):
        assert_state_close(got_p[c], got_b[c],
                           jax.tree.map(lambda x: np.asarray(x)[c], ft_p),
                           jax.tree.map(lambda x: np.asarray(x)[c], ft_b),
                           init_p, **TRAJECTORY)


# ---------------------------------------------------------------------------
# the engine's logic, exactly, with a recording trainer
# ---------------------------------------------------------------------------

SHAPE = (69, 69, 69)
TRAIN = {0: [0, 1, 2, 3, 4], 1: [5, 6, 7], 2: [8], 3: [9, 10]}
TEST = {0: [11], 1: [11], 2: [10], 3: [11]}


def _recorded_engine(rounds: int):
    rng = np.random.default_rng(0)
    X = rng.integers(0, 256, (12,) + SHAPE, dtype=np.uint8)
    y = rng.integers(0, 2, 12).astype(np.int8)
    data = build_federated_data(
        X, y, {c: np.asarray(v, np.int64) for c, v in TRAIN.items()},
        {c: np.asarray(v, np.int64) for c, v in TEST.items()}, CPU)
    cfg = ExperimentConfig(
        algorithm="dpsgd",
        data=DataConfig(dataset="synthetic", synthetic_shape=SHAPE),
        optim=OptimConfig(batch_size=2, epochs=2),
        fed=FedConfig(client_num_in_total=4, frac=0.5, comm_round=rounds,
                      frequency_of_the_test=rounds))
    trainer = LocalTrainer(create_model("3dcnn", SHAPE), cfg.optim, CPU,
                           torch.Generator().manual_seed(0))
    asked = []
    eng = create_engine("dpsgd", cfg, data, trainer,
                        perms_for=lambda r, c, n: asked.append((r, c)))
    rec = Recorder()
    trainer.local_train = rec
    logged, evaluated = [], []
    eng.metrics = lambda r, **values: logged.append((r, values))
    # the model is not run: the states are two small leaves, and each
    # evaluation records what it was given and returns fixed metrics
    metrics = {"acc": 0.5, "loss": 1.0, "auc": 0.5, "acc_pooled": 0.5}

    def evaluate(kind):
        return lambda *states: evaluated.append((kind, states)) or metrics

    eng.eval_global = evaluate("global")
    eng.eval_personalized = evaluate("personal")
    gen = torch.Generator().manual_seed(3)
    init = ({"w": torch.randn(3, 4, generator=gen),
             "b": torch.randn(4, generator=gen)},
            {"mean": torch.randn(4, generator=gen)})
    return eng, rec, asked, logged, evaluated, init


def _mix(M, states, c):
    return {k: sum(float(M[c, j]) * s[k] for j, s in enumerate(states))
            for k in states[0]}


def test_rounds_and_the_finetune_after_round_99():
    """100 rounds on a state of two small leaves: each round every client
    trains from its row of the round's mixing matrix applied to last
    round's models, at ``round_lr(round)``; no fine-tune before round 99;
    after it every client trains ``w_global`` (the mean of the personal
    models) for ``epochs`` at ``round_lr(-1)`` with round -1's
    permutations, the fine-tuned models are evaluated and logged, and the
    personal models are those of round 99's training, untouched by the
    fine-tune."""
    eng, rec, asked, logged, evaluated, init = _recorded_engine(100)
    res = eng.train(init_state=init)
    cfg = eng.cfg
    C = eng.num_clients
    per, _ = eng.broadcast_states(*init, C)
    calls = iter(rec.calls)
    for r in range(100):
        M = eng.mixing_matrix(r)
        outs = []
        for c in range(C):
            call = next(calls)
            want = _mix(M, per, c)
            for k, v in want.items():
                torch.testing.assert_close(call["params"][k], v, rtol=1e-6,
                                           atol=1e-7)
            assert call["lr"] == float(round_lr(cfg.optim, r, CPU))
            assert call["epochs"] == cfg.optim.epochs
            assert call["n"] == len(TRAIN[c])
            shift = call["lr"] * (call["epochs"] + call["n"] / 8)
            outs.append({k: v + shift for k, v in call["params"].items()})
        per = outs
    g = {k: torch.stack([p[k] for p in per]).mean(0) for k in per[0]}
    tuned = []
    for c in range(C):
        call = next(calls)
        for k, v in g.items():
            torch.testing.assert_close(call["params"][k], v, rtol=1e-6,
                                       atol=1e-7)
        assert call["lr"] == float(round_lr(cfg.optim, -1, CPU))
        assert call["epochs"] == cfg.optim.epochs
        shift = call["lr"] * (call["epochs"] + call["n"] / 8)
        tuned.append({k: v + shift for k, v in call["params"].items()})
    assert next(calls, None) is None
    # evaluations: global and personal at rounds 0 and 99, then the
    # fine-tuned models, then the final global model
    assert [kind for kind, _ in evaluated] == ["global", "personal"] * 2 + [
        "personal", "global"]
    ft_params = evaluated[-2][1][0]
    for c in range(C):
        for k, v in tuned[c].items():
            torch.testing.assert_close(ft_params[c][k], v, rtol=0, atol=0)
    assert asked[-C:] == [(-1, c) for c in range(C)]
    assert [r for r, _ in asked].count(-1) == C
    fts = [v for r, v in logged if "finetune_after_round" in v]
    assert len(fts) == 1 and fts[0]["finetune_after_round"] == 99
    assert set(fts[0]["finetune_personal"]) >= {"acc", "loss", "auc"}
    for c in range(C):
        for k, v in per[c].items():
            torch.testing.assert_close(res["personal_params"][c][k], v,
                                       rtol=1e-6, atol=1e-7)
    for k, v in g.items():
        torch.testing.assert_close(res["global_params"][k], v, rtol=1e-6,
                                   atol=1e-7)
    # evaluated at round 0 and the last round only (frequency 100)
    assert [h["round"] for h in res["history"]] == [0, 99]


def test_engine_names_are_the_references():
    """The port's registry names exactly the reference's algorithms."""
    assert set(ENGINES) == set(J_ENGINES)


CLI_BASE = ["--device", "cpu", "--dataset", "synthetic",
            "--synthetic_shape", "69", "69", "69",
            "--synthetic_num_subjects", "8", "--client_num_in_total", "4",
            "--comm_round", "1", "--batch_size", "4"]


@pytest.mark.parametrize("argv", [
    ["--algorithm", "dpsgd", "--cs", "ring", "--frac", "0.5", "--epochs",
     "1"],
    ["--algorithm", "fedavg", "--client_optimizer", "adam", "--epochs", "1"],
    ["--algorithm", "sub-fedavg", "--epochs", "2"]])
def test_cli_runs(argv, capsys, monkeypatch):
    """The CLI on the CPU at 69^3 (D-PSGD with ring neighbours, FedAvg with
    Adam, Sub-FedAvg by the reference's other name): its last
    line is one JSON object with the run's history and no model state."""
    monkeypatch.setenv("NIDT_FAST_STEM", "1")
    with torch_threads(2):
        assert main([*argv, *CLI_BASE]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["history"]) == 1
    assert not {"personal_params", "global_params", "params",
                "personal"} & set(out)
