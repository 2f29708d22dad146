"""The 2D vision path through the engines, held on the CPU against the
reference package's on the synthetic vision cohort (32x32x3 float images,
10 classes, softmax CE): SalientGrads and FedAvg on ``cnn_cifar10``, one
ResNet-18 ``local_train`` through the plain two-table ``fused_sgd``, and
the CLI on ``--dataset synthetic_vision``."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.data import partition as JP
from neuroimagedisttraining_tpu.data import vision as JV
from neuroimagedisttraining_tpu_torch.__main__ import main
from neuroimagedisttraining_tpu_torch.ops.masks import is_weight_kernel
from neuroimagedisttraining_tpu_torch.weights import (
    masks_from_flax, params_from_flax,
)

from torch_port_support import (
    LOSS_RTOL, TRAJECTORY, assert_metrics_close, assert_state_close,
    run_engine_pair, torch_threads,
)

SHAPE = (32, 32, 3)
CLASSES = 10


def _federation(method: str, alpha: float, seed: int = 1):
    """The synthetic vision cohort (160 training and 48 test images) over 4
    clients by the reference's own partitioner: ``(X, y, train_map,
    test_map)`` and the test pool."""
    Xtr, ytr, Xte, yte = JV.synthetic_vision_cohort(160, 48, seed=seed)
    train_map = JV.vision_partition(ytr, 4, alpha, method, seed=seed,
                                    num_classes=CLASSES)
    test_map = JV.proportional_test_split(
        yte, JP.record_data_stats(ytr, train_map), 4, seed=seed,
        num_classes=CLASSES)
    return (Xtr, ytr, train_map, test_map), (Xte, yte)


_RUNS: dict = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    def run(name):
        if name not in _RUNS:
            sg = name == "salientgrads"
            data, pool = _federation("n_cls" if sg else "dir",
                                     2 if sg else 0.5)
            with torch_threads(2):
                _RUNS[name] = run_engine_pair(
                    name, data,
                    dict(lr=0.01, batch_size=16, epochs=1,
                         fused_update=True),
                    dict(client_num_in_total=4, comm_round=1 if sg else 2,
                         frequency_of_the_test=1),
                    tmp_path_factory.mktemp(name), shape=SHAPE,
                    sparsity=dict(dense_ratio=0.5, itersnip_iterations=1),
                    model="cnn_cifar10", num_classes=CLASSES,
                    eval_pool=pool)
        return _RUNS[name]
    return run


def test_salientgrads_mask_and_round(runs):
    """SalientGrads on ``cnn_cifar10`` (``n_cls`` 2, 4 clients, 1 round)
    under the reference's IterSNIP rows: the port's phase-1 mask differs
    from the reference's only at entries whose normalized score lies within
    1e-3 (relative) of the threshold, in at most 1e-4 of the maskable
    weights (the slice test's share) at the same density; phase 2 under the
    reference's mask: the round loss rtol 1e-4, the global weights at
    ``TRAJECTORY``, pruned weights 0, the evaluations and ``stat_info``'s
    FLOPs and communicated parameters as the reference's."""
    jres, pres, jeng, peng, init = runs("salientgrads")
    ref = masks_from_flax(jax.tree.map(np.asarray, jres["masks"]))
    pmasks, pthr = peng.generate_global_mask(*init)
    scores = peng.mean_scores(*init)
    norm = sum(float(s.double().sum()) for k, s in scores.items()
               if is_weight_kernel(k, s))
    thr = float(pthr)
    n_diff = kept = total = 0
    for k, m in ref.items():
        if not is_weight_kernel(k, m):
            assert torch.all(pmasks[k] == 1) and torch.all(m == 1), k
            continue
        total += m.numel()
        kept += int(pmasks[k].sum())
        diff = pmasks[k] != m
        n_diff += int(diff.sum())
        near = (scores[k].double() / norm)[diff]
        assert torch.all((near - thr).abs() <= 1e-3 * thr), k
    assert n_diff <= 1e-4 * total
    assert kept / total == pytest.approx(jres["mask_density"], abs=1e-5)
    assert pres["history"][0]["train_loss"] == pytest.approx(
        jres["history"][0]["train_loss"], rel=LOSS_RTOL)
    assert_state_close(pres["params"], pres["batch_stats"], jres["params"],
                       jres["batch_stats"], init[0], **TRAJECTORY)
    for k, m in pres["masks"].items():
        assert torch.all(pres["params"][k][m == 0] == 0), k
    for which in ("final_global", "final_personal"):
        assert_metrics_close(pres[which], jres[which])
    for k in ("sum_training_flops", "sum_comm_params"):
        assert peng.stat_info[k] == jeng.stat_info[k], k


def test_fedavg_rounds(runs):
    """FedAvg on ``cnn_cifar10`` (``dir`` 0.5, 4 clients, 2 rounds and the
    final fine-tune): global weights at ``TRAJECTORY``, each round's loss
    rtol 1e-4, the evaluations as the reference's."""
    jres, pres, _, _, (init_p, _) = runs("fedavg")
    assert_state_close(pres["params"], pres["batch_stats"], jres["params"],
                       jres["batch_stats"], init_p, **TRAJECTORY)
    assert len(pres["history"]) == len(jres["history"]) == 2
    for hp, hj in zip(pres["history"], jres["history"]):
        assert hp["train_loss"] == pytest.approx(hj["train_loss"],
                                                 rel=LOSS_RTOL)
    assert_metrics_close(pres["final_global"], jres["final_global"])


def test_resnet18_local_train_two_tables():
    """One client's ``local_train`` of ResNet-18 (GroupNorm; 62 leaves, two
    of ``fused_sgd``'s 32-leaf tables) with ``--fused_update``, 2 epochs of
    2 steps under the reference's permutations and the clip taken: the
    port's plain fused step against the reference's fused update, the mean
    loss rtol 1e-4 and the weights at ``TRAJECTORY``."""
    from neuroimagedisttraining_tpu.config import OptimConfig as JOptim
    from neuroimagedisttraining_tpu.core.trainer import (
        ClientState, LocalTrainer as JTrainer, epoch_perms_for,
    )
    from neuroimagedisttraining_tpu.models import create_model as jcreate
    from neuroimagedisttraining_tpu_torch.config import OptimConfig
    from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
    from neuroimagedisttraining_tpu_torch.models import create_model
    from neuroimagedisttraining_tpu_torch.ops.fused_update import MAX_LEAVES

    optim = dict(lr=0.05, batch_size=4, epochs=2, fused_update=True,
                 grad_clip=0.5)
    jt = JTrainer(jcreate("resnet18", num_classes=CLASSES), JOptim(**optim),
                  num_classes=CLASSES)
    X, y, _, _ = JV.synthetic_vision_cohort(8, 1, seed=4)
    n, nmax, E, B = 7, 8, 2, 4
    key = jax.random.key(5)
    cs = jt.init_client_state(jax.random.key(0), jnp.zeros((1,) + SHAPE))
    jp = jax.tree.map(np.asarray, cs.params)
    cs = ClientState(params=jp, batch_stats={}, opt_state=jt.opt.init(jp),
                     rng=key)
    perms = np.asarray(epoch_perms_for(key, E, nmax, n))
    ref_cs, ref_loss = jax.jit(functools.partial(
        jt.local_train, epochs=E, batch_size=B, max_samples=nmax))(
        cs, jnp.asarray(X), jnp.asarray(y), n, jnp.float32(optim["lr"]))
    params, bstats = params_from_flax(jp, {})
    assert len(params) == 62 > MAX_LEAVES
    tr = LocalTrainer(create_model("resnet18", SHAPE, CLASSES),
                      OptimConfig(**optim), torch.device("cpu"),
                      torch.Generator().manual_seed(0), num_classes=CLASSES)
    _, g, _ = tr.loss_and_grad(params, bstats, torch.from_numpy(X[:B]),
                               torch.from_numpy(y[:B]))
    assert float(torch.cat([v.reshape(-1) for v in g.values()]).norm()) \
        > optim["grad_clip"]
    with torch_threads(2):
        p, _, loss = tr.local_train(
            params, bstats, torch.from_numpy(X), torch.from_numpy(y), n,
            torch.tensor(np.float32(optim["lr"])), E, B, nmax,
            perms=torch.from_numpy(perms.copy()))
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_RTOL)
    assert_state_close(p, None, jax.tree.map(np.asarray, ref_cs.params),
                       None, params, **TRAJECTORY)


def test_cli_on_synthetic_vision(capsys):
    """The CLI on ``--dataset synthetic_vision`` (10 classes implied, a
    ``site`` partition read as ``dir``) with SalientGrads on ResNet-18 and
    ``--fused_update``: its last line is one JSON object with finite
    metrics and the mask's density."""
    with torch_threads(4):
        assert main(["--device", "cpu", "--dataset", "synthetic_vision",
                     "--model", "resnet18", "--algorithm", "salientgrads",
                     "--fused_update", "--client_num_in_total", "4",
                     "--comm_round", "1", "--batch_size", "4",
                     "--epochs", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mask_density"] == pytest.approx(0.5, abs=0.01)
    assert all(np.isfinite(out["final_global"][k])
               for k in ("acc", "loss", "auc"))
    assert "params" not in out and "masks" not in out
