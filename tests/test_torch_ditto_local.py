"""Ditto and Local-only end to end: the reference package's engine and the
port's on the same federation, initial weights, epoch permutations (Ditto's
personal track from each client's round key folded with 1) and dropout
keep-masks, with both switches of the flagship path on (``--fused_update``,
``NIDT_FAST_STEM=1``; on the CPU both sides take their plain paths).
Tiny3DCNN at 12x14x12 (test_torch_flagship_engines.py holds both engines
against the reference on the flagship model at 69^3), batch 2, 1 round
of 1 epoch (Ditto: 1 personal epoch) over 3 clients: two site clients
and a third with test rows but no training rows, which is never sampled
(Ditto) or takes no step (Local).
The runs take several SGD steps, so they are held at the tolerances of
``torch_port_support.TRAJECTORY`` (a ReLU input within float32 rounding of
0 is active on one side only); test_torch_engines.py holds the engines'
logic exactly."""

import jax
import numpy as np
import pytest

from neuroimagedisttraining_tpu.data.partition import site_partition
from neuroimagedisttraining_tpu.data.synthetic import generate_synthetic_abcd
from neuroimagedisttraining_tpu_torch.ops import _cuda

from torch_port_support import (
    EVAL_LOSS_RTOL, LOSS_RTOL, TRAJECTORY, assert_metrics_close,
    assert_state_close, run_engine_pair, torch_threads,
)

OPTIM = dict(batch_size=2, epochs=1, fused_update=True)
FED = dict(client_num_in_total=3, comm_round=1, frequency_of_the_test=1,
           lamda=0.5, local_epochs=1)
MODEL, SHAPE = "3dcnn_tiny", (12, 14, 12)


def _federation():
    c = generate_synthetic_abcd(num_subjects=12, shape=SHAPE,
                                num_sites=2, seed=0)
    train_map, test_map, _ = site_partition(c["site"], seed=42)
    train_map[2] = np.array([], dtype=np.int64)
    test_map[2] = np.concatenate([test_map[0], test_map[1]])
    return c["X"], c["y"], train_map, test_map


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{name: (reference result, port result, reference engine, port
    engine, initial state)}`` for Ditto and Local."""
    mp = pytest.MonkeyPatch()
    mp.setenv("NIDT_FAST_STEM", "1")
    try:
        with torch_threads(2):
            data = _federation()
            out = {}
            for name in ("ditto", "local"):
                before = sum(_cuda.counts().values())
                out[name] = run_engine_pair(name, data, OPTIM, FED,
                                            tmp_path_factory.mktemp(name),
                                            shape=SHAPE, model=MODEL)
                # CPU tensors: plain paths only, no kernel launched
                assert sum(_cuda.counts().values()) == before
            yield out
    finally:
        mp.undo()


def _client(tree, c):
    return jax.tree.map(lambda x: np.asarray(x)[c], tree)


def test_ditto_tracks_match(runs):
    """Ditto: the global track's loss (rtol 1e-4) and aggregated weights,
    and each sampled client's personal weights after the proximal personal
    track (at ``TRAJECTORY``; the reference returns no BN stats here, they
    are held through the evaluations below); the client without training
    rows is not sampled and keeps the initial model exactly."""
    jres, pres, _, peng, (init_p, init_b) = runs["ditto"]
    assert pres["history"][0]["train_loss"] == pytest.approx(
        jres["history"][0]["train_loss"], rel=LOSS_RTOL)
    assert_state_close(pres["params"], None, jres["params"], None, init_p,
                       **TRAJECTORY)
    assert peng.real_clients == 2
    for c in range(2):
        assert_state_close(pres["personal_params"][c], None,
                           _client(jres["personal_params"], c), None, init_p,
                           **TRAJECTORY)
    for got, want in ((pres["personal_params"][2], init_p),
                      (pres["personal_batch_stats"][2], init_b)):
        for k, v in want.items():
            assert np.array_equal(got[k].numpy(), v.numpy()), k


def test_local_states_match(runs):
    """Local-only: the sample-weighted round loss (rtol 1e-4) and every
    client's own model (weights and BN stats at ``TRAJECTORY``); the client
    without training rows takes no step and keeps the initial model
    exactly."""
    jres, pres, _, _, (init_p, init_b) = runs["local"]
    assert pres["history"][0]["train_loss"] == pytest.approx(
        jres["history"][0]["train_loss"], rel=LOSS_RTOL)
    for c in range(2):
        assert_state_close(pres["personal_params"][c],
                           pres["personal_batch_stats"][c],
                           _client(jres["personal_params"], c),
                           _client(jres["personal_batch_stats"], c), init_p,
                           **TRAJECTORY)
    for got, want in ((pres["personal_params"][2], init_p),
                      (pres["personal_batch_stats"][2], init_b)):
        for k, v in want.items():
            assert np.array_equal(got[k].numpy(), v.numpy()), k


@pytest.mark.parametrize("name", ["ditto", "local"])
def test_metrics_and_history_match(runs, name):
    """The personal evaluation (``assert_metrics_close``), and each history
    entry: the same keys and round, the train loss rtol 1e-4, the eval
    loss (Local) rtol 2e-2, the accuracies and AUC (Ditto: personal and
    global accuracy) equal."""
    jres, pres, _, _, _ = runs[name]
    assert_metrics_close(pres["final_personal"], jres["final_personal"])
    assert len(pres["history"]) == len(jres["history"])
    for got, ref in zip(pres["history"], jres["history"]):
        assert set(got) == set(ref)
        assert got["round"] == ref["round"]
        assert got["train_loss"] == pytest.approx(ref["train_loss"],
                                                  rel=LOSS_RTOL)
        if "loss" in ref:
            assert got["loss"] == pytest.approx(ref["loss"],
                                                rel=EVAL_LOSS_RTOL)
        for k in set(ref) - {"round", "train_loss", "loss"}:
            assert abs(got[k] - ref[k]) <= 1e-9, k


@pytest.mark.parametrize("name", ["ditto", "local"])
def test_result_keys_and_stat_info_match(runs, name):
    """The port returns every key the reference's engine returns, and its
    ``stat_info`` accumulators hold the reference's values."""
    jres, pres, jeng, peng, _ = runs[name]
    assert set(jres) <= set(pres)
    for k in ("global_test_acc", "person_test_acc"):
        assert peng.stat_info[k] == pytest.approx(jeng.stat_info[k], abs=1e-9)
    for k in ("sum_comm_params", "sum_training_flops", "nonfinite_uploads"):
        assert peng.stat_info[k] == jeng.stat_info[k], k
