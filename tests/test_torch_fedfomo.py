"""FedFomo: the port's engine against the reference package's.

- The validation carve (``carve_val_split``) bit for bit.
- The neighbour choice (the coin flip, the top ``fomo_m`` by ``p_choose``
  in ``np.argsort``'s tie order, the uniform draw) and the round's pair
  list: equal to the reference's over 50 rounds, on ``p_choose`` matrices
  that start all equal and then tie often.
- The aggregation alone (validation losses and distances at the pairs,
  the weight update, the ReLU-normalised delta mix) on the arrays the
  reference's own round handed its aggregation, at ``WEIGHT_RTOL`` and
  ``MODEL_RTOL``: it is kept apart from the training
  trajectory because the weights divide a difference of validation losses
  by a distance, and a weight near 0 that changes sign changes what the
  ReLU lets through.
- The whole run: both engines on the same federation (Tiny3DCNN at
  12x14x12: test_torch_flagship_engines.py holds the engine against the
  reference on the flagship model at 69^3; 4 clients with a validation
  split of 0.2 of their training rows, batch 3, 1 epoch, 2 rounds,
  ``--frac 0.5``), initial weights, permutations and dropout keep-masks,
  with ``--fused_update`` and ``NIDT_FAST_STEM=1`` (plain paths on the
  CPU): personal states at ``TRAJECTORY``, the count of
  weight entries whose sign differs reported and bounded.
- The refusal to run without a validation split (constructor and CLI).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.config import (
    ExperimentConfig as JExp, FedConfig as JFed,
)
from neuroimagedisttraining_tpu.data import federate as JF
from neuroimagedisttraining_tpu.engines.fedfomo import FedFomoEngine as JFomo
from neuroimagedisttraining_tpu_torch.__main__ import main
from neuroimagedisttraining_tpu_torch.config import (
    ExperimentConfig, FedConfig,
)
from neuroimagedisttraining_tpu_torch.data import federate as PF
from neuroimagedisttraining_tpu_torch.engines.fedfomo import (
    FedFomoEngine as PFomo,
)
from neuroimagedisttraining_tpu_torch.ops import _cuda
from neuroimagedisttraining_tpu_torch.weights import params_from_flax

from torch_port_support import (
    LOSS_RTOL, TRAJECTORY, assert_metrics_close, assert_state_close,
    TINY_MODEL, TINY_SHAPE, four_client_federation, run_engine_pair,
    torch_threads,
)

OPTIM = dict(batch_size=3, epochs=1, fused_update=True)
FED = dict(client_num_in_total=4, frac=0.5, comm_round=2,
           frequency_of_the_test=1)
VAL_FRACTION = 0.2
#: the aggregation on the same stacks: the validation losses agree to the
#: forward pass's rounding (~1e-6 relative), but a weight divides the
#: difference of two of them (own last model against another) by a
#: distance, so its relative error is that rounding over the losses'
#: relative difference. Measured: weights within 1.45e-3 relative on the
#: reference's round-1 arrays, 1.6e-3 on stacks of two local epochs from
#: the initial model (held at WEIGHT_RTOL; p_choose, which gains them,
#: within the same error of each weight); the aggregated models within
#: 3.5e-7 and 4.8e-4 of the largest entry of the leaf over the stacks the
#: weights mix (held at MODEL_RTOL); no weight differs in sign
WEIGHT_RTOL = 5e-3
MODEL_RTOL = 2e-3


def _federation():
    X, y, train, test = four_client_federation(TINY_SHAPE)
    val, train = JF.carve_val_split(train, VAL_FRACTION, seed=42)
    return (X, y, train, test), val


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``(reference result, port result, reference engine, port engine,
    initial state, captured)``: ``captured`` holds, for each round of the
    reference's run, the arguments and the outputs of its ``_fomo_agg``
    (copied to the host from inside its jitted round, which they leave
    unchanged)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("NIDT_FAST_STEM", "1")
    captured = []
    agg = JFomo._fomo_agg

    def spy(self, *args):
        out = agg(self, *args)
        jax.debug.callback(
            lambda a, o: captured.append(jax.tree.map(np.asarray, (a, o))),
            args, out)
        return out

    mp.setattr(JFomo, "_fomo_agg", spy)
    try:
        with torch_threads(2):
            before = sum(_cuda.counts().values())
            data, val = _federation()
            out = run_engine_pair("fedfomo", data, OPTIM, FED,
                                  tmp_path_factory.mktemp("fedfomo"),
                                  val_map=val, shape=TINY_SHAPE,
                                  model=TINY_MODEL)
            jax.effects_barrier()
            assert sum(_cuda.counts().values()) == before
            assert len(captured) == FED["comm_round"]
            yield (*out, captured)
    finally:
        mp.undo()


@pytest.mark.parametrize("fraction", [0.1, 0.2, 0.5])
def test_carve_val_split_bit_equal(fraction):
    """The same validation and training rows, in the same order, for
    clients of 0 to 40 rows: one ``RandomState(seed + 1)`` stream across
    the clients, ``max(1, int(n * fraction))`` held out."""
    rng = np.random.default_rng(3)
    train = {c: rng.permutation(200)[:n].astype(np.int64)
             for c, n in enumerate([0, 1, 2, 3, 7, 10, 40, 13])}
    for seed in (0, 42, 1024):
        jv, jt = JF.carve_val_split(train, fraction, seed)
        pv, pt = PF.carve_val_split(train, fraction, seed)
        assert list(pv) == list(jv) and list(pt) == list(jt)
        for c in train:
            np.testing.assert_array_equal(pv[c], jv[c])
            np.testing.assert_array_equal(pt[c], jt[c])
            assert pv[c].dtype == jv[c].dtype


def _bare(cls, fed: dict, clients: int, real: int, seed: int = 7):
    eng = cls.__new__(cls)
    jax_side = cls is JFomo
    eng.cfg = (JExp if jax_side else ExperimentConfig)(
        seed=seed, fed=(JFed if jax_side else FedConfig)(**fed))
    eng.num_clients, eng.real_clients = clients, real
    return eng


@pytest.mark.parametrize("clients,frac,m", [(4, 0.5, 5), (10, 0.3, 2),
                                            (7, 0.5, 3), (5, 1.0, 5)])
def test_neighbour_choice_and_pairs_match(clients, frac, m):
    """Over 50 rounds: every client's ``benefit_choose``, the adjacency,
    the count of model transfers and the padded pair list, equal to the
    reference's (its training loop builds the adjacency the same way).
    ``p_choose`` starts all 1 (every entry tied) and then grows by weights
    rounded to 0.5, so ties stay common."""
    fed = dict(client_num_in_total=clients, frac=frac, fomo_m=m)
    ref = _bare(JFomo, fed, clients, clients)
    port = _bare(PFomo, fed, clients, clients)
    rng = np.random.default_rng(clients)
    pch = np.ones((clients, clients), np.float32)
    for r in range(50):
        A = np.zeros((clients, clients), np.float32)
        transfers = 0
        for c in range(clients):
            want = ref.benefit_choose(r, c, pch[c])
            np.testing.assert_array_equal(port.benefit_choose(r, c, pch[c]),
                                          want)
            nei = np.unique(want)
            A[c, nei] = 1.0
            transfers += len(nei) - (1 if c in nei else 0)
        got_A, got_t = port.adjacency(r, pch)
        np.testing.assert_array_equal(got_A, A)
        assert got_t == transfers
        for a, b in zip(port.pairs_from_adjacency(A),
                        ref.pairs_from_adjacency(A)):
            np.testing.assert_array_equal(a, b)
        pch = pch + np.round(rng.normal(size=pch.shape) * 2) / 2 * A


def _clients(stacked_p, stacked_b, C):
    out = [params_from_flax(jax.tree.map(lambda x: np.asarray(x)[c],
                                         stacked_p),
                            jax.tree.map(lambda x: np.asarray(x)[c],
                                         stacked_b)) for c in range(C)]
    return [p for p, _ in out], [b for _, b in out]


@pytest.fixture(scope="module")
def ref_agg(run):
    """The reference engine's ``_fomo_agg``, jitted once for the module."""
    return jax.jit(run[2]._fomo_agg)


@pytest.mark.parametrize("case", ["as_run", "neighbour_better"])
def test_fomo_aggregation_on_reference_stacks(run, ref_agg, case):
    """The reference's own round 1 (its last models, the round-0 aggregate,
    distinct across clients; the models its clients trained from them;
    their losses, weights, p_choose, adjacency, pair list and validation
    rows), as its jitted round handed them to ``_fomo_agg``, against the
    outputs it returned (``as_run``: only client 3's own weight is above
    0, so the other clients keep their last models). Then the same arrays
    through the reference's ``_fomo_agg`` with client 0's last model set to
    answer its validation rows wrong with a logit of 10 (``fc2``: its
    neighbours' models and its new one beat it, so the ReLU passes
    neighbour weights and the mix runs). On each, the port's
    ``fomo_aggregate`` gives the reference's weights and ``p_choose``
    within ``WEIGHT_RTOL``, aggregated params and BN stats within
    ``MODEL_RTOL`` of the largest entry of the leaf over the last and new
    stacks (which the weights mix) and the mean loss; no weight differs in
    sign."""
    *_, jeng, peng, _, captured = run
    C = jeng.num_clients
    args, ref = captured[1]
    (p1, b1, p2, b2, losses, weights, pch, A, pair_c, pair_n, *rows) = args
    if case == "neighbour_better":
        y0 = rows[1][0][:int(rows[2][0])]  # client 0's validation labels
        wrong = -10.0 if y0.mean() >= 0.5 else 10.0
        k, b = p1["fc2"]["kernel"], p1["fc2"]["bias"]
        p1 = {**p1, "fc2": {
            "kernel": np.concatenate([np.zeros_like(k[:1]), k[1:]]),
            "bias": np.concatenate([np.full_like(b[:1], wrong), b[1:]])}}
        ref = jax.tree.map(np.asarray, ref_agg(
            p1, b1, p2, b2, losses, weights, pch, A, pair_c, pair_n, *rows))
    positive = ref[2] > 0
    assert positive.any()
    if case == "neighbour_better":
        assert (positive & ~np.eye(C, dtype=bool) & (A > 0)).any()
    assert A.sum() > C  # some client receives a neighbour's model
    got_pairs = peng.pairs_from_adjacency(A)
    np.testing.assert_array_equal(got_pairs[0], pair_c)
    np.testing.assert_array_equal(got_pairs[1], pair_n)
    last_p, last_b = _clients(p1, b1, C)
    new_p, new_b = _clients(p2, b2, C)
    # the last models differ between clients: the pair distances are not 0
    assert any(not torch.equal(last_p[0][k], last_p[c][k])
               for c in range(1, C) for k in last_p[0])
    with torch_threads(2):
        got = peng.fomo_aggregate(
            last_p, last_b, new_p, new_b, torch.tensor(losses),
            torch.tensor(weights), torch.tensor(pch), A, pair_c, pair_n,
            got_pairs[2])
    agg_p, agg_b, w, p_choose, loss = got
    np.testing.assert_allclose(w.numpy(), ref[2], rtol=WEIGHT_RTOL)
    # p_choose gained the weights: each entry within the weight's error
    err = np.abs(p_choose.numpy() - ref[3])
    assert (err <= WEIGHT_RTOL * np.abs(ref[2]) + 1e-6 * np.abs(ref[3])
            ).all(), err
    assert np.array_equal(w.numpy() > 0, ref[2] > 0)
    assert float(loss) == pytest.approx(float(ref[4]), rel=1e-6)
    ref_p, ref_b = _clients(ref[0], ref[1], C)
    for got_s, ref_s, stacks in ((agg_p, ref_p, last_p + new_p),
                                 (agg_b, ref_b, last_b + new_b)):
        for k in ref_s[0]:
            scale = max(float(st[k].abs().max()) for st in stacks)
            for c in range(C):
                np.testing.assert_allclose(
                    got_s[c][k].numpy(), ref_s[c][k].numpy(), rtol=0,
                    atol=MODEL_RTOL * scale, err_msg=f"{c} {k}")


def test_personal_states_match(run):
    """Each client's personal weights at ``TRAJECTORY``, or, where the
    reference's client kept its initial model (no weight above 0 in either
    round: its own training raised its validation loss and its neighbours'
    models were its own), the initial model bit for bit; at least one
    client moved. The final ``weights`` agree in the sign of every entry
    (two SGD steps and two aggregations apart; measured: none differs)."""
    jres, pres, jeng, _, (init_p, _), _ = run
    moved = 0
    for c in range(jeng.num_clients):
        ref = jax.tree.map(lambda x: np.asarray(x)[c],
                           jres["personal_params"])
        ref_t, _ = params_from_flax(ref, {})
        got = pres["personal_params"][c]
        if all(torch.equal(v, init_p[k]) for k, v in ref_t.items()):
            assert all(torch.equal(v, init_p[k]) for k, v in got.items()), c
            continue
        moved += 1
        assert_state_close(got, None, ref, None, init_p, **TRAJECTORY)
    assert moved > 0
    w_ref = np.asarray(jres["weights"])
    w = pres["weights"].numpy()
    flipped = int(((w > 0) != (w_ref > 0)).sum())
    assert flipped == 0, f"{flipped} weights differ in sign"
    np.testing.assert_allclose(pres["p_choose"].numpy(),
                               np.asarray(jres["p_choose"]), rtol=2e-2,
                               atol=2e-2 * np.abs(jres["p_choose"]).max())


def test_history_metrics_and_stat_info_match(run):
    """Per round the train loss at ``LOSS_RTOL`` and the personal accuracy
    equal; the final personal evaluation; the reference's result keys; the
    FLOPs and communicated parameters of ``stat_info`` equal."""
    jres, pres, jeng, peng, _, _ = run
    assert set(jres) <= set(pres)
    assert len(pres["history"]) == len(jres["history"]) == 2
    for got, ref in zip(pres["history"], jres["history"]):
        assert set(got) == set(ref) and got["round"] == ref["round"]
        assert got["train_loss"] == pytest.approx(ref["train_loss"],
                                                  rel=LOSS_RTOL)
        assert got["personal_acc"] == ref["personal_acc"]
    assert_metrics_close(pres["final_personal"], jres["final_personal"])
    for k in ("sum_comm_params", "sum_training_flops"):
        assert peng.stat_info[k] == jeng.stat_info[k], k
    assert peng.stat_info["sum_comm_params"] > 0
    assert peng.stat_info["person_test_acc"] == pytest.approx(
        jeng.stat_info["person_test_acc"], abs=1e-9)


def test_refuses_without_validation_split(capsys):
    """Without a validation split the engine raises ``ValueError`` (as the
    reference's does) and the CLI exits with an error naming
    ``--val_fraction``."""
    X, y, train, test = four_client_federation()
    data = PF.build_federated_data(X, y, train, test, torch.device("cpu"))
    trainer = SimpleNamespace(device=torch.device("cpu"))
    with pytest.raises(ValueError, match="validation split"):
        PFomo(ExperimentConfig(algorithm="fedfomo"), data, trainer)
    with pytest.raises(SystemExit):
        main(["--algorithm", "fedfomo", "--device", "cpu"])
    assert "--val_fraction" in capsys.readouterr().err


def test_cli_runs(capsys, monkeypatch):
    """The CLI on the CPU at 69^3 with ``--val_fraction 0.2``: its last line
    is one JSON object with the run's history and no model state."""
    import json

    monkeypatch.setenv("NIDT_FAST_STEM", "1")
    with torch_threads(2):
        assert main(["--algorithm", "fedfomo", "--dataset", "synthetic",
                     "--val_fraction", "0.2",
                     "--frac", "0.5", "--device", "cpu", "--synthetic_shape",
                     "69", "69", "69", "--synthetic_num_subjects", "16",
                     "--client_num_in_total", "4", "--comm_round", "1",
                     "--batch_size", "4", "--epochs", "1",
                     "--fused_update"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["history"]) == 1 and "final_personal" in out
    assert not {"personal_params", "weights", "p_choose"} & set(out)
