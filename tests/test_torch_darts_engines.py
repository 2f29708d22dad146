"""The DARTS family through the federation, held on the CPU against the
reference package on the synthetic vision cohort (32x32x3, 10 classes,
4 clients): SalientGrads on a tiny fixed network (``darts``), FedAvg on a
tiny search supernet (``darts_search``, its alphas trained as weights), a
``darts`` training batch under ``bf16_mixed`` at the reference's own bf16
pin; ``--model darts`` through ``build_experiment``; and the port's fp32
contract in ``LocalTrainer`` and its ``--no_snip_mask``, ``--tag`` and
``--ci`` flags against the reference CLI's.

Both packages' ``create_model`` build the tiny nets for the names
``darts`` and ``darts_search`` here (C=4, 3 cells; the search net of
1-node cells): the full-width nets are held leaf by leaf in
``test_torch_darts.py``."""

import argparse
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuroimagedisttraining_tpu.models as JM
import neuroimagedisttraining_tpu_torch.models as PM
from neuroimagedisttraining_tpu.data import partition as JP
from neuroimagedisttraining_tpu.data import vision as JV
from neuroimagedisttraining_tpu.models import darts as J
from neuroimagedisttraining_tpu_torch.models import darts as P
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
TINY_FIXED = dict(c=4, layers=3)
TINY_SEARCH = dict(c=4, layers=3, steps=1, multiplier=1)


@contextlib.contextmanager
def tiny_darts():
    """Inside, ``darts`` and ``darts_search`` build tiny nets in both
    packages."""
    jorig, porig = JM.create_model, PM.create_model

    def jcreate(name, num_classes=1, dtype=jnp.float32, remat=None):
        if name == "darts":
            return J.DartsNetwork(genotype=J.DARTS_V2, num_classes=num_classes,
                                  dtype=dtype, **TINY_FIXED)
        if name == "darts_search":
            return J.DartsSearchNet(num_classes=num_classes, dtype=dtype,
                                    **TINY_SEARCH)
        return jorig(name, num_classes=num_classes, dtype=dtype, remat=remat)

    def pcreate(name, input_shape, num_classes=1, dtype=torch.float32,
                remat=False):
        if name == "darts":
            return P.DartsNetwork(genotype=P.DARTS_V2, num_classes=num_classes,
                                  dtype=dtype, **TINY_FIXED)
        if name == "darts_search":
            return P.DartsSearchNet(num_classes=num_classes, dtype=dtype,
                                    **TINY_SEARCH)
        return porig(name, input_shape, num_classes, dtype=dtype, remat=remat)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, "create_model", jcreate)
        mp.setattr(PM, "create_model", pcreate)
        yield


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
    def run(name, model, fed=None):
        key = (name, model)
        if key not in _RUNS:
            sg = name == "salientgrads"
            data, pool = _federation("n_cls" if sg else "dir",
                                     2 if sg else 0.5)
            with torch_threads(2), tiny_darts():
                _RUNS[key] = run_engine_pair(
                    name, data,
                    dict(lr=0.01, batch_size=16, epochs=1,
                         fused_update=True),
                    dict(client_num_in_total=4, comm_round=1,
                         frequency_of_the_test=1, **(fed or {})),
                    tmp_path_factory.mktemp(name), shape=SHAPE,
                    sparsity=dict(dense_ratio=0.5, itersnip_iterations=1),
                    model=model, num_classes=CLASSES, eval_pool=pool)
        return _RUNS[key]
    return run


def test_salientgrads_on_darts(runs):
    """SalientGrads on the tiny ``darts`` (``n_cls`` 2, 4 clients, 1 round)
    under the reference's IterSNIP rows: the port's phase-1 mask differs
    from the reference's only at entries whose normalized score lies within
    1e-3 (relative) of the threshold, in at most 1e-4 of the maskable
    weights (the slice test's share) at the same density; phase 2 under
    the reference's mask: the round loss rtol 1e-4, the global weights and
    BatchNorm stats at ``TRAJECTORY``, pruned weights 0, the evaluations
    and ``stat_info``'s FLOPs and communicated parameters as the
    reference's."""
    jres, pres, jeng, peng, init = runs("salientgrads", "darts")
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


def test_fedavg_on_darts_search(runs):
    """FedAvg on the tiny search supernet (``dir`` 0.5, 4 clients, 1 round
    and the final fine-tune): the alphas train as ordinary weights and are
    never masked (no ``weight`` leaf); the global weights and alphas at
    ``TRAJECTORY``, the round's loss rtol 1e-4, the evaluations as the
    reference's; no ``batch_stats``."""
    jres, pres, _, _, (init_p, init_b) = runs("fedavg", "darts_search")
    assert init_b == {} and pres["batch_stats"] == {}
    for k in P.ARCH_KEYS:
        assert not is_weight_kernel(k, init_p[k])
        assert not torch.equal(pres["params"][k], init_p[k]), k
    assert_state_close(pres["params"], pres["batch_stats"], jres["params"],
                       jres["batch_stats"], init_p, **TRAJECTORY)
    assert pres["history"][0]["train_loss"] == pytest.approx(
        jres["history"][0]["train_loss"], rel=LOSS_RTOL)
    assert_metrics_close(pres["final_global"], jres["final_global"])


def test_darts_bf16_mixed_at_the_reference_pin():
    """The tiny ``darts`` under ``bf16_mixed`` (32x32x3, batch 4): the
    port's bfloat16 training batch against the reference's at the
    reference's own bf16 pin
    (the loss within 2e-3 absolute, the weights after one SGD step at lr
    0.01 within 5e-3 absolute), its gradients no farther from the
    reference's bf16 ones than those are from the reference's float32 ones
    (L2 over every leaf), and loss, gradients and BatchNorm stats
    float32."""
    from neuroimagedisttraining_tpu.config import OptimConfig as JOptim
    from neuroimagedisttraining_tpu.core.trainer import (
        ClientState, LocalTrainer as JTrainer,
    )
    from neuroimagedisttraining_tpu_torch.config import OptimConfig
    from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer

    rng = np.random.default_rng(2)
    X = rng.standard_normal((4, *SHAPE)).astype(np.float32)
    y = (np.arange(4) % CLASSES).astype(np.int32)
    grads = {}
    for prec, dt in (("fp32", jnp.float32), ("bf16_mixed", jnp.bfloat16)):
        jt = JTrainer(J.DartsNetwork(genotype=J.DARTS_V2, num_classes=CLASSES,
                                     dtype=dt, **TINY_FIXED),
                      JOptim(precision=prec), num_classes=CLASSES)
        if prec == "fp32":
            cs = jt.init_client_state(jax.random.key(0),
                                      jnp.zeros((1,) + X.shape[1:]))
            jp = jax.tree.map(np.asarray, cs.params)
            jb = jax.tree.map(np.asarray, cs.batch_stats)
            cs = ClientState(params=jp, batch_stats=jb, opt_state=None,
                             rng=jax.random.key(1))
            loss, g, _, _ = jax.jit(jt.loss_and_grad)(cs, X, y)
        else:  # op by op: under jit XLA keeps excess precision in fusions
            loss, g, _, _ = jt.loss_and_grad(cs, jnp.asarray(X),
                                             jnp.asarray(y))
        grads[prec] = (float(loss), params_from_flax(
            jax.tree.map(np.asarray, g), {})[0])
    params, bstats = params_from_flax(jp, jb)
    port = LocalTrainer(P.DartsNetwork(genotype=P.DARTS_V2,
                                       num_classes=CLASSES,
                                       dtype=torch.bfloat16, **TINY_FIXED),
                        OptimConfig(precision="bf16_mixed"),
                        torch.device("cpu"), torch.Generator().manual_seed(0),
                        num_classes=CLASSES)
    with torch_threads(2):
        loss, g, new_b = port.loss_and_grad(params, bstats,
                                            torch.from_numpy(X),
                                            torch.from_numpy(y))
    assert loss.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in (*g.values(),
                                                  *new_b.values()))
    jloss16, g16 = grads["bf16_mixed"]
    _, g32 = grads["fp32"]
    assert abs(float(loss) - jloss16) < 2e-3
    lr = 0.01
    for k, ref in g16.items():
        np.testing.assert_allclose((params[k] - lr * g[k]).numpy(),
                                   (params[k] - lr * ref).numpy(), rtol=0,
                                   atol=5e-3, err_msg=k)

    def dist(a, b):
        return float(torch.cat([(a[k] - b[k]).reshape(-1) for k in b]).norm())
    assert dist(g, g16) <= dist(g16, g32)


def _cfg(*argv):
    from neuroimagedisttraining_tpu_torch.__main__ import (
        add_args, config_from_args,
    )
    return config_from_args(add_args(argparse.ArgumentParser()).parse_args(
        list(argv)))


def _jcfg(*argv):
    from neuroimagedisttraining_tpu.__main__ import (
        add_args, config_from_args,
    )
    return config_from_args(add_args(argparse.ArgumentParser()).parse_args(
        list(argv)))


def test_build_experiment_full_width_darts():
    """``--model darts`` on the CLI's synthetic vision cohort builds
    through ``build_experiment`` on the CPU: the full-width network (919
    leaves, 478 running stats), a 4-client federation of 32x32x3 images,
    and a first training batch with finite logits and loss."""
    from neuroimagedisttraining_tpu_torch.__main__ import build_experiment

    eng, _ = build_experiment(_cfg(
        "--dataset", "synthetic_vision", "--model", "darts",
        "--algorithm", "salientgrads", "--client_num_in_total", "4"), "cpu")
    model = eng.trainer.model
    assert type(model).__name__ == "DartsNetwork" and model.layers == 20
    params, bstats = eng.init_global_state()
    assert (len(params), len(bstats)) == (919, 478)
    with torch_threads(4):
        loss, grads, _ = eng.trainer.loss_and_grad(
            params, bstats, eng.data.X_train[0][:2], eng.data.y_train[0][:2])
    assert np.isfinite(float(loss)) and len(grads) == 919


def test_local_trainer_applies_the_fp32_contract(monkeypatch):
    """A ``LocalTrainer`` built for a CUDA device without
    ``build_experiment`` runs under the fp32 contract: TF32 off in cuDNN
    and cuBLAS, cuDNN deterministic, benchmark off, set before the model
    reaches the device (here the availability check says yes and the model
    stays where it is); a CPU trainer leaves the switches alone."""
    from neuroimagedisttraining_tpu_torch.config import OptimConfig
    from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    seen = {}

    class Stub(torch.nn.Module):
        def to(self, *a, **kw):
            seen.update(tf32=cudnn.allow_tf32, mm=matmul.allow_tf32,
                        det=cudnn.deterministic, bench=cudnn.benchmark)
            return self

    def wrong():
        for mod, name, value in ((cudnn, "allow_tf32", True),
                                 (matmul, "allow_tf32", True),
                                 (cudnn, "deterministic", False),
                                 (cudnn, "benchmark", True)):
            monkeypatch.setattr(mod, name, value)

    wrong()
    LocalTrainer(Stub(), OptimConfig(), torch.device("cpu"),
                 torch.Generator())
    assert seen == dict(tf32=True, mm=True, det=False, bench=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    tr = LocalTrainer(Stub(), OptimConfig(), torch.device("cuda"),
                      torch.Generator())
    assert seen == dict(tf32=False, mm=False, det=True, bench=False)
    assert tr.device == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalTrainer(Stub(), OptimConfig(), torch.device("cuda"),
                     torch.Generator())


def test_snip_mask_and_tag_flags_match_the_reference_cli():
    """``--no_snip_mask`` and ``--tag`` parse as the reference CLI's: the
    dense escape hatch (``snip_mask`` False; on by default) and the
    identity's last part (``exp`` by default), the identities equal."""
    base = ("--algorithm", "salientgrads", "--dataset", "cifar10",
            "--model", "darts", "--partition_method", "dir")
    for extra in ((), ("--no_snip_mask",), ("--tag", "sweep7"),
                  ("--no_snip_mask", "--tag", "x", "--ci", "1")):
        got, want = _cfg(*base, *extra), _jcfg(*base, *extra)
        assert got.sparsity.snip_mask == want.sparsity.snip_mask \
            == ("--no_snip_mask" not in extra)
        assert got.fed.ci == want.fed.ci == ("--ci" in extra)
        assert got.tag == want.tag
        assert got.identity() == want.identity()
        assert got.identity().endswith("_" + want.tag)


def test_no_snip_mask_trains_dense(capsys):
    """SalientGrads under ``--no_snip_mask`` (the reference's
    ``ones_mask`` after phase 1): every mask entry kept, density 1."""
    import json

    from neuroimagedisttraining_tpu_torch.__main__ import main

    with torch_threads(2):
        assert main(["--device", "cpu", "--dataset", "synthetic_vision",
                     "--model", "cnn_cifar10", "--algorithm",
                     "salientgrads", "--no_snip_mask",
                     "--client_num_in_total", "4", "--comm_round", "1",
                     "--batch_size", "16", "--epochs", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mask_density"] == 1.0


def _ci_engines(ci: bool, tmp):
    """The reference's FedAvg engine and the port's on ``cnn_cifar10`` over
    the 4-client vision federation, with ``ci`` set, untrained: ``(jeng,
    peng, reference initial params and stats)``."""
    from neuroimagedisttraining_tpu.config import (
        DataConfig as JData, ExperimentConfig as JExp, FedConfig as JFed,
    )
    from neuroimagedisttraining_tpu.core.trainer import (
        LocalTrainer as JTrainer,
    )
    from neuroimagedisttraining_tpu.data.federate import (
        build_federated_data as jbuild,
    )
    from neuroimagedisttraining_tpu.engines import create_engine as jcreate
    from neuroimagedisttraining_tpu.utils.logging import ExperimentLogger
    from neuroimagedisttraining_tpu_torch.config import (
        ExperimentConfig, FedConfig,
    )
    from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
    from neuroimagedisttraining_tpu_torch.data.federate import (
        build_federated_data,
    )
    from neuroimagedisttraining_tpu_torch.engines import create_engine

    (X, y, tr, te), (Xe, ye) = _federation("dir", 0.5)
    fed = dict(client_num_in_total=4, ci=ci)
    jcfg = JExp(model="cnn_cifar10", num_classes=CLASSES,
                data=JData(dataset="synthetic"), fed=JFed(**fed))
    jeng = jcreate("fedavg", jcfg, jbuild(X, y, tr, te, X_eval=Xe,
                                          y_eval=ye),
                   JTrainer(JM.create_model("cnn_cifar10",
                                            num_classes=CLASSES),
                            jcfg.optim, num_classes=CLASSES),
                   mesh=None, logger=ExperimentLogger(
                       str(tmp), "synthetic", jcfg.identity(),
                       console=False))
    pcfg = ExperimentConfig(model="cnn_cifar10", num_classes=CLASSES,
                            fed=FedConfig(**fed))
    cpu = torch.device("cpu")
    peng = create_engine("fedavg", pcfg, build_federated_data(
        X, y, tr, te, cpu, X_eval=Xe, y_eval=ye), LocalTrainer(
        PM.create_model("cnn_cifar10", SHAPE, CLASSES), pcfg.optim, cpu,
        torch.Generator().manual_seed(0), num_classes=CLASSES))
    gs = jeng.init_global_state()
    return jeng, peng, (jax.tree.map(np.asarray, gs.params),
                        jax.tree.map(np.asarray, gs.batch_stats))


def test_ci_evaluates_client_zero(tmp_path):
    """``--ci`` (client 0 only in every evaluation) against the reference
    engine's CI mode on ``cnn_cifar10``, untrained: the global evaluation
    of the reference's initial weights and the personal evaluation of four
    different client models summarise client 0 alone, as the reference's
    (accuracy and AUC equal, loss rtol 2e-2); the personal one is client
    0's own model on its own rows, and without CI both differ."""
    from neuroimagedisttraining_tpu.core.trainer import ClientState

    got = {}
    for ci in (True, False):
        jeng, peng, (jp, jb) = _ci_engines(ci, tmp_path / str(ci))
        assert peng.eval_ids() == ((0,) if ci else (0, 1, 2, 3))
        scales = np.float32([1.0, 0.5, 2.0, -1.0])
        jstack = jax.tree.map(lambda a: np.stack([a * s for s in scales]),
                              jp)
        jstates = ClientState(params=jstack, batch_stats=jb, opt_state=None,
                              rng=None)
        params, bstats = params_from_flax(jp, jb)
        per = [{k: v * float(s) for k, v in params.items()} for s in scales]
        with torch_threads(2):
            got[ci] = (peng.eval_global(params, bstats),
                       peng.eval_personalized(per, [bstats] * 4))
        if ci:
            assert_metrics_close(got[ci][0], jeng.eval_global(jp, jb))
            assert_metrics_close(got[ci][1],
                                 jeng.eval_personalized(jstates))
            with torch_threads(2):
                alone = peng._eval_clients([(per[0], bstats)])
            assert got[ci][1] == alone
    for a, b in zip(got[True], got[False]):
        assert a["loss"] != b["loss"]


@pytest.mark.parametrize("model", ["resnet18_ip", "darts_search"])
def test_evaluate_pads_batch_statistics_models(model):
    """A model that normalises by the batch's own statistics in evaluation
    (``resnet18_ip``'s ``ipbn``, the tiny DARTS search net) is evaluated on
    10 test rows, 7 of them valid, as the reference evaluates it: one chunk
    of 32 padded with zero rows. The correct count and the valid count
    equal, the loss sum and the scores rtol 1e-4 and 1e-4 of the largest;
    without the padding the statistics, and the scores, would differ."""
    from neuroimagedisttraining_tpu.config import OptimConfig as JOptim
    from neuroimagedisttraining_tpu.core.trainer import (
        LocalTrainer as JTrainer,
    )
    from neuroimagedisttraining_tpu_torch.config import OptimConfig
    from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer

    rng = np.random.default_rng(4)
    X = rng.standard_normal((10, *SHAPE)).astype(np.float32)
    y = (np.arange(10) % CLASSES).astype(np.int32)
    valid = np.arange(10) < 7
    with tiny_darts():
        jt = JTrainer(JM.create_model(model, num_classes=CLASSES), JOptim(),
                      num_classes=CLASSES)
        pm = PM.create_model(model, SHAPE, CLASSES)
    cs = jax.jit(lambda k: jt.init_client_state(
        k, jnp.zeros((1,) + SHAPE)))(jax.random.key(0))
    want = jax.tree.map(np.asarray, jax.jit(jt.evaluate)(
        cs.params, cs.batch_stats, X, y, valid))
    params, bstats = params_from_flax(jax.tree.map(np.asarray, cs.params),
                                      jax.tree.map(np.asarray,
                                                   cs.batch_stats))
    port = LocalTrainer(pm, OptimConfig(), torch.device("cpu"),
                        torch.Generator().manual_seed(0),
                        num_classes=CLASSES)
    assert pm.eval_batch_stats
    with torch_threads(2):
        got = port.evaluate(params, bstats, torch.from_numpy(X),
                            torch.from_numpy(y), torch.from_numpy(valid))
    assert float(got["test_correct"]) == float(want["test_correct"])
    assert float(got["test_total"]) == float(want["test_total"]) == 7
    assert float(got["test_loss"]) == pytest.approx(
        float(want["test_loss"]), rel=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=1e-4,
                               atol=1e-4 * np.abs(want["scores"]).max())
