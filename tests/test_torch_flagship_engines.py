"""The engines whose detailed pairs run on ``3dcnn_tiny`` (Ditto, Local,
DisPFL, D-PSGD, FedFomo, TurboAggregate, FedProx), each against the
reference package's engine on the flagship model: ``3DCNN``
(AlexNet3D_Dropout) at 69^3, with its 5^3 stem, the stem's BatchNorm and
the 128-unit dropout under the reference's keep-masks, and both switches
of the flagship path on (``--fused_update``, ``NIDT_FAST_STEM=1``; on the
CPU both sides take their plain paths).

Each pair runs one round of 1 epoch at batch 2 over two site clients of
two training rows and two test rows (FedFomo: three training rows, one
carved for validation), so each client takes one step a track, and the
engines that sample take one client a round (``--frac 0.5``; FedProx's
and TurboAggregate's fine-tune then trains both): the reference's SGD at
69^3 on the CPU is most of the cost. The model states
the reference returns (global, personal; BatchNorm statistics where it
returns them) are held at ``torch_port_support.TRAJECTORY``, the round's
train loss at ``LOSS_RTOL`` and the final evaluation by
``assert_metrics_close``. D-PSGD's fine-tune is held on the same inputs
as the reference's ``_finetune_jit``.

The engines' logic over several rounds is held in their own files
(test_torch_ditto_local.py, test_torch_dispfl.py, test_torch_dpsgd.py,
test_torch_fedfomo.py, test_torch_turboaggregate.py,
test_torch_fedavg.py), on the tiny model."""

import jax
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.data import federate as JF
from neuroimagedisttraining_tpu.data.synthetic import generate_synthetic_abcd
from neuroimagedisttraining_tpu_torch.ops import _cuda
from neuroimagedisttraining_tpu_torch.weights import params_from_flax

from torch_port_support import (
    LOSS_RTOL, TRAJECTORY, assert_metrics_close, assert_state_close,
    fixed_dropout, model_dropout_masks, run_engine_pair, torch_threads,
)

SHAPE = (69, 69, 69)
OPTIM = dict(batch_size=2, epochs=1, fused_update=True)
FED = dict(client_num_in_total=2, comm_round=1, frequency_of_the_test=1)
#: each engine's own flags (as its file's) and extra ``run_engine_pair``
#: arguments
ENGINES = {
    "ditto": (dict(frac=0.5, lamda=0.5, local_epochs=1), {}),
    "local": ({}, {}),
    "dispfl": (dict(frac=0.5, active=1.0),
               dict(sparsity=dict(dense_ratio=0.5, save_masks=True))),
    "dpsgd": (dict(frac=0.5), {}),
    "fedfomo": (dict(frac=0.5), {}),
    "turboaggregate": (dict(frac=0.5, mpc_backend="device"), {}),
    "fedprox": (dict(frac=0.5, lamda=0.5), {}),
}
#: the reference's model states: (weights, BatchNorm statistics) keys
STATES = (("params", "batch_stats"), ("global_params", "global_batch_stats"),
          ("personal_params", "personal_batch_stats"))


def _federation(train_rows: int):
    """Two site clients of ``train_rows`` training rows and two test rows
    each at 69^3: ``(X, y, train_map, test_map)``."""
    per = train_rows + 2
    c = generate_synthetic_abcd(num_subjects=2 * per, shape=SHAPE,
                                num_sites=2, seed=0)
    rows = [np.arange(i * per, (i + 1) * per) for i in range(2)]
    train = {i: r[:train_rows].astype(np.int64) for i, r in enumerate(rows)}
    test = {i: r[train_rows:].astype(np.int64) for i, r in enumerate(rows)}
    return c["X"], c["y"], train, test


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """The engine pair of a name, run once a module: ``(reference result,
    port result, reference engine, port engine, initial state)``."""
    done = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("NIDT_FAST_STEM", "1")

    def pair(name: str):
        if name not in done:
            fed, kw = ENGINES[name]
            with torch_threads(2):
                before = sum(_cuda.counts().values())
                if name == "fedfomo":
                    X, y, train, test = _federation(3)
                    val, train = JF.carve_val_split(train, 0.2, seed=42)
                    assert all(len(v) == 1 for v in val.values())
                    kw = dict(kw, val_map=val)
                    data = (X, y, train, test)
                else:
                    data = _federation(2)
                done[name] = run_engine_pair(
                    name, data, OPTIM, dict(FED, **fed),
                    tmp_path_factory.mktemp(name), shape=SHAPE,
                    model="3DCNN", **kw)
                # CPU tensors: plain paths only, no kernel launched
                assert sum(_cuda.counts().values()) == before
        return done[name]

    try:
        yield pair
    finally:
        mp.undo()


def _client(tree, c):
    return jax.tree.map(lambda x: np.asarray(x)[c], tree)


@pytest.mark.parametrize("name", list(ENGINES))
def test_states_match_reference_on_the_flagship(pairs, name):
    """Every model state the reference returns, at ``TRAJECTORY`` (with
    its BatchNorm statistics where the reference returns them); a client
    the round did not sample keeps the initial model on both sides."""
    jres, pres, jeng, _, (init_p, _) = pairs(name)
    held = 0
    for pk, bk in STATES:
        if pk not in jres:
            continue
        ref_b = jres.get(bk)
        if pk.startswith("personal"):
            for c in range(jeng.num_clients):
                ref_c = params_from_flax(_client(jres[pk], c), {})[0]
                if all(torch.equal(v, init_p[k]) for k, v in ref_c.items()):
                    # a client the round did not sample keeps the initial
                    # model, on both sides exactly
                    for k, v in init_p.items():
                        assert torch.equal(pres[pk][c][k], v), (c, k)
                    continue
                assert_state_close(
                    pres[pk][c],
                    pres[bk][c] if ref_b is not None else None,
                    _client(jres[pk], c),
                    _client(ref_b, c) if ref_b is not None else None,
                    init_p, **TRAJECTORY)
        else:
            assert_state_close(pres[pk],
                               pres[bk] if ref_b is not None else None,
                               jres[pk], ref_b, init_p, **TRAJECTORY)
        held += 1
    assert held


@pytest.mark.parametrize("name", list(ENGINES))
def test_loss_and_metrics_match_reference_on_the_flagship(pairs, name):
    """The round's train loss at ``LOSS_RTOL``, the history's keys, and
    each final evaluation the reference reports
    (``assert_metrics_close``)."""
    jres, pres, _, _, _ = pairs(name)
    assert set(jres) <= set(pres)
    assert len(pres["history"]) == len(jres["history"]) == 1
    got, ref = pres["history"][0], jres["history"][0]
    assert set(got) == set(ref) and got["round"] == ref["round"]
    assert got["train_loss"] == pytest.approx(ref["train_loss"],
                                              rel=LOSS_RTOL)
    finals = [k for k in ("final_global", "final_personal") if k in jres]
    assert finals
    for k in finals:
        assert_metrics_close(pres[k], jres[k])


def test_dpsgd_finetune_matches_reference_on_the_flagship(pairs):
    """D-PSGD's fine-tune from the initial model, the same inputs on both
    sides (the reference's ``_finetune_jit`` with its round -1 keys and the
    128-unit dropout's keep-masks, the port's permutations of round -1):
    every client's model at ``TRAJECTORY``."""
    _, _, jeng, peng, (init_p, init_b) = pairs("dpsgd")
    gs = jeng.init_global_state()
    jmasks, _ = model_dropout_masks("3DCNN", SHAPE, OPTIM["batch_size"],
                                    seed=1)
    with fixed_dropout(jmasks):
        ft_p, ft_b = jeng._finetune_jit(
            gs.params, gs.batch_stats, jeng.data,
            jeng.per_client_rngs(-1, np.arange(jeng.num_clients)),
            jeng.round_lr(-1))
    with torch_threads(2):
        got_p, got_b = peng.finetune(init_p, init_b)
    for c in range(jeng.num_clients):
        assert_state_close(got_p[c], got_b[c], _client(ft_p, c),
                           _client(ft_b, c), init_p, **TRAJECTORY)
