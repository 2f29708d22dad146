"""FedAvg (with its final fine-tune) and FedProx end to end: the reference
package's engine and the port's on the same cohort, initial weights, epoch
permutations (the round's and the fine-tune's) and dropout keep-masks,
with both switches of the flagship path on (``--fused_update``,
``NIDT_FAST_STEM=1``; on the CPU both sides take their plain paths).
Both on Tiny3DCNN at 12x14x12 (the AlexNet family's FedAvg pairs at 69^3
are in test_torch_zoo.py, and test_torch_flagship_engines.py holds FedProx
against the reference on the flagship model at 69^3), 2 site clients,
batch 2, 1 round of 1 epoch. The runs take several SGD steps, so they are
held at the tolerances of
``torch_port_support.TRAJECTORY`` (a ReLU input within float32 rounding of
0 is active on one side only); test_torch_engines.py holds the engines'
logic exactly."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.data.synthetic import generate_synthetic_abcd
from neuroimagedisttraining_tpu.data.partition import site_partition
from neuroimagedisttraining_tpu_torch.ops import _cuda

from torch_port_support import (
    LOSS_RTOL, TRAJECTORY, assert_metrics_close, assert_state_close,
    run_engine_pair, torch_threads,
)

OPTIM = dict(batch_size=2, epochs=1, fused_update=True)
FED = dict(client_num_in_total=2, comm_round=1, frequency_of_the_test=1)


#: the model and volume of each pair: the tiny model (test_torch_zoo.py
#: holds FedAvg pairs on the AlexNet family at 69^3, and
#: test_torch_flagship_engines.py holds FedProx on the flagship at 69^3)
PAIRS = {"fedavg": ("3dcnn_tiny", (12, 14, 12)),
         "fedprox": ("3dcnn_tiny", (12, 14, 12))}


def _cohort(shape=(69, 69, 69)):
    c = generate_synthetic_abcd(num_subjects=12, shape=shape,
                                num_sites=2, seed=0)
    train_map, test_map, _ = site_partition(c["site"], seed=42)
    return c["X"], c["y"], train_map, test_map


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{name: (reference result, port result, reference engine, port
    engine, initial state)}`` for FedAvg and FedProx (lamda 0.5)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("NIDT_FAST_STEM", "1")
    try:
        with torch_threads(2):
            out = {}
            for name, (model, shape) in PAIRS.items():
                before = sum(_cuda.counts().values())
                out[name] = run_engine_pair(
                    name, _cohort(shape), OPTIM, dict(FED, lamda=0.5),
                    tmp_path_factory.mktemp(name), shape=shape, model=model)
                # CPU tensors: plain paths only, no kernel launched
                assert sum(_cuda.counts().values()) == before
            yield out
    finally:
        mp.undo()


@pytest.mark.parametrize("name", ["fedavg", "fedprox"])
def test_round_loss_and_global_state_match(runs, name):
    """The round's sample-weighted loss (rtol 1e-4) and the aggregated
    global model (weights and BN stats at ``TRAJECTORY``)."""
    jres, pres, _, _, (init_p, _) = runs[name]
    assert [h["round"] for h in pres["history"]] == \
        [h["round"] for h in jres["history"]]
    assert pres["history"][0]["train_loss"] == pytest.approx(
        jres["history"][0]["train_loss"], rel=LOSS_RTOL)
    assert_state_close(pres["params"], pres["batch_stats"], jres["params"],
                       jres["batch_stats"], init_p, **TRAJECTORY)


@pytest.mark.parametrize("name", ["fedavg", "fedprox"])
def test_finetune_personal_states_match(runs, name):
    """The final fine-tune from the aggregated model at ``round_lr(-1)``:
    every client's personal state (weights and BN stats at
    ``TRAJECTORY``, against the distance from the initial weights)."""
    jres, pres, _, peng, (init_p, _) = runs[name]
    per = pres["personal"]
    assert len(per["params"]) == peng.num_clients
    for c in range(peng.num_clients):
        take = lambda t: jax.tree.map(lambda x: np.asarray(x)[c], t)  # noqa: E731
        assert_state_close(per["params"][c], per["batch_stats"][c],
                           take(jres["personal"].params),
                           take(jres["personal"].batch_stats), init_p,
                           **TRAJECTORY)


@pytest.mark.parametrize("name", ["fedavg", "fedprox"])
@pytest.mark.parametrize("which", ["final_global", "final_personal"])
def test_final_metrics_match(runs, name, which):
    """Global and personal evaluation after the fine-tune, and the history's
    per-round metrics (``assert_metrics_close``: accuracy and AUC equal,
    loss rtol 2e-2)."""
    jres, pres, _, _, _ = runs[name]
    assert_metrics_close(pres[which], jres[which])
    for got, ref in zip(pres["history"], jres["history"]):
        assert set(got) == set(ref)
        assert_metrics_close(got, ref)


@pytest.mark.parametrize("name", ["fedavg", "fedprox"])
def test_result_keys_and_stat_info_match(runs, name):
    """The port returns every key the reference's engine returns, and
    fills the same ``stat_info`` accumulators with the same accuracies."""
    jres, pres, jeng, peng, _ = runs[name]
    assert set(jres) <= set(pres)
    for k in ("global_test_acc", "person_test_acc"):
        assert peng.stat_info[k] == pytest.approx(jeng.stat_info[k], abs=1e-9)
    for k in ("sum_comm_params", "sum_training_flops", "nonfinite_uploads"):
        assert peng.stat_info[k] == jeng.stat_info[k], k


@pytest.mark.parametrize("name", ["fedavg", "fedprox"])
def test_experiment_log_matches(runs, name):
    """The experiment log: the same file names under ``<log_dir>/synthetic``
    and the same metric records (round index and keys, nested keys too)."""
    _, _, jeng, peng, _ = runs[name]
    assert (sorted(p.name for p in Path(peng.log.dir).iterdir())
            == sorted(p.name for p in Path(jeng.log.dir).iterdir()))

    def records(path):
        out = []
        for line in open(path):
            rec = json.loads(line)
            out.append({k: sorted(v) if isinstance(v, dict) else None
                        for k, v in rec.items() if k != "t"})
        return out

    assert records(peng.log.jsonl_path) == records(jeng.log.jsonl_path)


def test_fedprox_at_lamda_0_is_fedavg_bit_for_bit():
    """The trainer with the proximal pull at ``lamda = 0`` (FedProx's
    update, ``w -= (lr * 0) * (w - ref)``) equals the trainer without it
    (FedAvg's) bit for bit, over two steps from a moved reference."""
    from neuroimagedisttraining_tpu_torch.config import OptimConfig
    from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
    from neuroimagedisttraining_tpu_torch.models import create_model

    from torch_port_support import dropout_masks

    shape = (69, 69, 69)
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.integers(0, 256, (4,) + shape, dtype=np.uint8))
    y = torch.from_numpy(rng.integers(0, 2, 4).astype(np.int32))
    perms = torch.from_numpy(np.stack([rng.permutation(4)]))
    with torch_threads(2):
        model = create_model("3dcnn", shape)
        model.reset_parameters(torch.Generator().manual_seed(0))
        params = {k: v.detach().clone() for k, v in model.named_parameters()}
        bstats = {k: v.clone() for k, v in model.named_buffers()}
        ref = {k: v + 0.01 for k, v in params.items()}
        lr = torch.tensor(0.01)
        outs = []
        for kw in ({}, {"prox_lamda": 0.0, "prox_ref": ref}):
            tr = LocalTrainer(model, OptimConfig(fused_update=True),
                              torch.device("cpu"), torch.Generator(),
                              dropout_masks=dropout_masks(2, 128)[1])
            outs.append(tr.local_train(params, bstats, X, y, 4, lr, 1, 2, 4,
                                       perms=perms, **kw))
    (p0, b0, l0), (p1, b1, l1) = outs
    assert torch.equal(l0, l1)
    for a, b in ((p0, p1), (b0, b1)):
        for k in a:
            assert torch.equal(a[k].view(torch.int32),
                               b[k].view(torch.int32)), k


def test_prox_pull_matches_reference():
    """The proximal pull ``w -= (lr * lamda) * (w - ref)`` on the port's
    leaves against the reference's expression in a jitted program: within
    one float32 rounding of the result (XLA may contract the multiply and
    subtract into one FMA)."""
    from neuroimagedisttraining_tpu_torch.core.trainer import prox_pull_

    rng = np.random.default_rng(8)
    shapes = [(64, 1, 5, 5, 5), (64,), (128, 64)]
    w = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ref = [(a + 0.01 * rng.standard_normal(a.shape)).astype(np.float32)
           for a in w]
    lr, lamda = np.float32(0.00998), 0.5
    want = jax.jit(lambda w, r, lr: [a - lr * lamda * (a - b)
                                     for a, b in zip(w, r)])(w, ref, lr)
    got = [torch.from_numpy(a.copy()) for a in w]
    prox_pull_(got, [torch.from_numpy(a) for a in ref], torch.tensor(lr),
               lamda)
    for g, x in zip(got, want):
        x = np.asarray(x)
        np.testing.assert_allclose(g.numpy(), x, rtol=0,
                                   atol=float(np.spacing(np.abs(x)).max()))
