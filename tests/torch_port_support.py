"""Shared by the ``test_torch_*`` parity tests: fixed dropout for the
reference's flax model, and the reference's AlexNet3D at a test volume."""

import contextlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import torch


@contextlib.contextmanager
def torch_threads(n: int = 2):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def fixed_dropout(masks: dict[str, np.ndarray]):
    """Context in which every training-mode ``nn.Dropout`` of a flax model
    applies the given keep-mask (by module name, e.g. ``Dropout_0``)
    instead of drawing one; under ``vmap``/``scan`` it is one constant for
    every client and step. Deterministic calls pass through."""
    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, nn.Dropout) and context.method_name == "__call__":
            x = args[0]
            det = nn.merge_param("deterministic", mod.deterministic,
                                 kwargs.get("deterministic"))
            if det or mod.rate == 0:
                return x
            keep = jnp.asarray(masks[mod.name])
            return jnp.where(keep, x / (1.0 - mod.rate), jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    return nn.intercept_methods(intercept)


def dropout_masks(batch: int, flat: int, seed: int = 0):
    """Keep-masks for AlexNet3D's two dropouts at ``batch`` rows: numpy for
    the reference (by module name) and torch for the port (in order)."""
    rng = np.random.default_rng(seed)
    m0 = rng.random((batch, flat)) < 0.5
    m1 = rng.random((batch, 64)) < 0.5
    return ({"Dropout_0": m0, "Dropout_1": m1},
            (torch.from_numpy(m0), torch.from_numpy(m1)))


def model_dropout_masks(model: str, shape, batch: int, seed: int = 0):
    """Keep-masks for the dropouts of a model of the zoo at ``batch`` rows,
    as :func:`dropout_masks` gives them: the AlexNet family's two (its
    flatten and 64 units), Tiny3DCNN's one (its flatten), ResNet3D's
    none."""
    from neuroimagedisttraining_tpu_torch.models import (
        flat_features, tiny_flat_features,
    )

    from neuroimagedisttraining_tpu_torch.models import MODELS_2D, _CANONICAL

    model = model.lower()
    if model in ("resnet3d", "resnet_l3", "resnet3d_l3"):
        return {}, ()
    if _CANONICAL.get(model) in MODELS_2D:
        if _CANONICAL[model] == "cnn_dropout":
            raise ValueError("no fixed keep-masks for cnn_dropout here")
        return {}, ()
    if model in ("3dcnn_tiny", "tiny3dcnn"):
        rng = np.random.default_rng(seed)
        m0 = rng.random((batch, tiny_flat_features(tuple(shape)))) < 0.5
        return {"Dropout_0": m0}, (torch.from_numpy(m0),)
    width = 256 if model in ("3dcnn_deeper",
                             "alexnet3d_deeper_dropout") else 128
    return dropout_masks(batch, flat_features(tuple(shape), width), seed)


#: the engine pairs' model where another file holds the engine against the
#: reference at the stem's width (test_torch_flagship_engines.py: Ditto,
#: Local, DisPFL, D-PSGD, FedFomo, TurboAggregate and FedProx on the
#: flagship model at 69^3)
TINY_MODEL, TINY_SHAPE = "3dcnn_tiny", (12, 14, 12)


def four_client_federation(shape=(69, 69, 69)):
    """16 synthetic subjects of ``shape`` over 4 clients of 2-3 training
    rows and 1-2 test rows each: ``(X, y, train_map, test_map)``."""
    from neuroimagedisttraining_tpu.data.synthetic import (
        generate_synthetic_abcd,
    )

    c = generate_synthetic_abcd(num_subjects=16, shape=tuple(shape),
                                num_sites=4, seed=0)
    rows = [[0, 1, 2], [3, 4, 5], [6, 7], [8, 9, 10]]
    tests = [[11], [12], [13], [14, 15]]
    train_map = {i: np.asarray(r, np.int64) for i, r in enumerate(rows)}
    test_map = {i: np.asarray(r, np.int64) for i, r in enumerate(tests)}
    return c["X"], c["y"], train_map, test_map


def jax_alexnet(shape, seed: int = 0, **optim_kw):
    """The reference's AlexNet3D trainer and its initial (params,
    batch_stats) as numpy trees, for volumes of ``shape``."""
    from neuroimagedisttraining_tpu.config import OptimConfig
    from neuroimagedisttraining_tpu.core.trainer import LocalTrainer
    from neuroimagedisttraining_tpu.models import create_model

    model = create_model("3dcnn", num_classes=1, remat=False)
    trainer = LocalTrainer(model, OptimConfig(**optim_kw), num_classes=1)
    cs = trainer.init_client_state(jax.random.key(seed),
                                   jnp.zeros((1,) + tuple(shape)))
    return (trainer, jax.tree.map(np.asarray, cs.params),
            jax.tree.map(np.asarray, cs.batch_stats))


def rng_after_local_train(jeng, key, epochs: int):
    """The rng the reference's ``local_train`` leaves behind after
    ``epochs`` epochs from ``key`` (its round program's replay of the
    chain: one split at entry, one 3-way split a scan step over
    ``epochs * ceil(max_samples / B)`` steps)."""
    from types import SimpleNamespace

    from neuroimagedisttraining_tpu.engines.program import RoundCtx

    return RoundCtx.rng_after_local_train(SimpleNamespace(eng=jeng),
                                          key[None], epochs)[0]


def reference_perms(jeng, nmax: int, epochs: int, local_epochs: int = 1):
    """A port engine's ``perms_for``: the epoch permutations the reference
    engine ``jeng`` draws for client ``c`` in round ``r`` (its per-client
    key of that round; FedAvg's fine-tune is round ``comm_round``); on
    Ditto's personal track those of the key folded with 1; for Sub-FedAvg's
    first epoch those of one epoch, and for its tail epochs those of the
    rng the first epoch's ``local_train`` leaves behind."""
    from neuroimagedisttraining_tpu.core.trainer import epoch_perms_for

    def perms_for(r, c, n, track="global"):
        key = jeng.per_client_rngs(r, np.array([c]))[0]
        e = epochs
        if track == "personal":
            key, e = jax.random.fold_in(key, 1), local_epochs
        elif track == "first":
            e = 1
        elif track == "tail":
            key, e = rng_after_local_train(jeng, key, 1), epochs - 1
        return torch.from_numpy(np.asarray(
            epoch_perms_for(key, e, nmax, n)).copy())

    return perms_for


def reference_probe_rows(jeng, epochs: int, batch_size: int):
    """DisPFL's ``screen_idx_for``: the reference's gradient-probe rows of
    client ``c`` in round ``r``, drawn from the rng its ``local_train``
    leaves behind."""
    def screen_idx_for(r, c, n):
        key = jeng.per_client_rngs(r, np.array([c]))[0]
        brng, _ = jax.random.split(rng_after_local_train(jeng, key, epochs))
        idx = jax.random.randint(brng, (batch_size,), 0, max(int(n), 1))
        return torch.from_numpy(np.asarray(idx).astype(np.int64))

    return screen_idx_for


def reference_snip_rows(jeng, iterations: int, batch_size: int):
    """SalientGrads' ``snip_idx_for``: the IterSNIP batch rows the
    reference engine ``jeng`` draws for client ``c`` in phase 1."""
    from neuroimagedisttraining_tpu.ops.snip import iter_snip_batch_indices

    def snip_idx_for(c, n):
        key = jeng.per_client_rngs(-1, np.array([c]))[0]
        return torch.from_numpy(np.asarray(iter_snip_batch_indices(
            key, iterations, batch_size, int(n))).copy())

    return snip_idx_for


def reference_initial_masks(jeng, jparams) -> list:
    """The reference DisPFL engine's initial per-client masks, one port
    mask dict a client."""
    from neuroimagedisttraining_tpu_torch.weights import masks_from_flax

    stacked, _ = jeng.init_masks_all(jparams)
    stacked = jax.tree.map(np.asarray, stacked)
    return [masks_from_flax(jax.tree.map(lambda m: m[c], stacked))
            for c in range(jeng.num_clients)]


def evaluate_in_one_chunk(jtrainer) -> None:
    """Let the reference trainer ``jtrainer`` evaluate a client's test stack
    in one chunk of its own rows instead of zero-padded chunks of 32. For a
    model that normalises with running statistics in evaluation every row's
    output is its own, so the metrics are the same (the sums over a
    client's rows may round in another order); the padding is what costs:
    at 69^3 it is most of a reference engine run on the CPU. A model that
    normalises by the batch in evaluation keeps the reference's chunks."""
    full = jtrainer.evaluate
    jtrainer.evaluate = (lambda params, bstats, X, y, valid, batch_size=None:
                         full(params, bstats, X, y, valid,
                              batch_size=max(1, X.shape[0])))


def run_engine_pair(name: str, data, optim: dict, fed: dict, tmp,
                    shape=(69, 69, 69), seed: int = 0,
                    sparsity: dict | None = None, val_map: dict | None = None,
                    model: str = "3DCNN", num_classes: int = 1,
                    eval_pool: tuple | None = None, setup=None,
                    exp: dict | None = None):
    """The reference's engine ``name`` and the port's on the same federation,
    model (``model`` with ``num_classes`` outputs, in ``optim``'s
    precision), initial weights, epoch permutations and dropout keep-masks
    (DisPFL: its initial masks and gradient-probe rows too; SalientGrads:
    its IterSNIP rows, and phase 2 under the reference's mask), each run
    through ``train()``, both logging under ``tmp``. ``data`` is ``(X, y,
    train_map, test_map)``, ``shape`` one sample's; ``eval_pool`` an
    ``(X, y)`` pool of their own that ``test_map`` indexes (the vision
    datasets'); ``val_map`` a validation split of the training rows
    (FedFomo's), where given; the reference evaluates in one chunk a
    client (``evaluate_in_one_chunk``) unless the model normalises by the
    batch in evaluation; ``setup(jeng, peng)`` runs on each port
    engine before it trains (e.g. to give it the reference's noise draws);
    ``exp`` holds fields of both packages' ``ExperimentConfig`` (the
    telemetry's, e.g. ``health_stats``). Returns
    ``(reference result, port result, reference engine, port engine, port
    initial state)``; the port engine's ``rerun()`` runs it again with the
    same inputs, and ``rebuild(fed_over, mesh)`` makes a port engine of
    the same inputs with the port's ``FedConfig`` fields ``fed_over``
    replaced, on the device mesh ``mesh``."""
    from neuroimagedisttraining_tpu.config import (
        DataConfig as JData, ExperimentConfig as JExp, FedConfig as JFed,
        OptimConfig as JOptim, SparsityConfig as JSparsity,
    )
    from neuroimagedisttraining_tpu.core.optim import (
        compute_dtype as jcompute_dtype,
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
    from neuroimagedisttraining_tpu_torch.config import (
        DataConfig, ExperimentConfig, FedConfig, OptimConfig, SparsityConfig,
    )
    from neuroimagedisttraining_tpu_torch.core.optim import compute_dtype
    from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
    from neuroimagedisttraining_tpu_torch.data.federate import (
        build_federated_data,
    )
    from neuroimagedisttraining_tpu_torch.engines import create_engine
    from neuroimagedisttraining_tpu_torch.models import create_model
    from neuroimagedisttraining_tpu_torch.weights import (
        masks_from_flax, params_from_flax,
    )

    X, y, train_map, test_map = data
    X_eval, y_eval = eval_pool if eval_pool is not None else (None, None)
    sparsity = sparsity or {}
    precision = optim.get("precision", "fp32")
    jcfg = JExp(model=model, num_classes=num_classes, algorithm=name,
                data=JData(dataset="synthetic", partition_method="site"),
                optim=JOptim(**optim), fed=JFed(**fed),
                sparsity=JSparsity(**sparsity), log_dir=str(tmp / "ref"),
                **(exp or {}))
    jfed = jbuild(X, y, train_map, test_map, val_map=val_map, X_eval=X_eval,
                  y_eval=y_eval)
    jtrainer = JTrainer(jmodel(model, num_classes=num_classes, remat=False,
                               dtype=jcompute_dtype(precision)),
                        jcfg.optim, num_classes=num_classes)
    if not getattr(create_model(model, tuple(shape), num_classes),
                   "eval_batch_stats", False):
        evaluate_in_one_chunk(jtrainer)
    jeng = jcreate(name, jcfg, jfed, jtrainer, mesh=None,
                   logger=ExperimentLogger(str(tmp / "ref"), "synthetic",
                                           jcfg.identity(), console=False))
    gs = jeng.init_global_state()
    nmax = int(jfed.X_train.shape[1])
    jmasks, pmasks = model_dropout_masks(model, shape, optim["batch_size"],
                                         seed=1)
    with fixed_dropout(jmasks):
        jres = jeng.train()

    pcfg = ExperimentConfig(
        model=model, num_classes=num_classes, algorithm=name,
        data=DataConfig(dataset="synthetic", synthetic_shape=tuple(shape)),
        optim=OptimConfig(**optim), fed=FedConfig(**fed),
        sparsity=SparsityConfig(**sparsity), log_dir=str(tmp / "port"),
        **(exp or {}))
    cpu = torch.device("cpu")
    pfed = build_federated_data(X, y, train_map, test_map, cpu,
                                val_map=val_map, X_eval=X_eval,
                                y_eval=y_eval)
    epochs = optim.get("epochs", 2)
    init = params_from_flax(jax.tree.map(np.asarray, gs.params),
                            jax.tree.map(np.asarray, gs.batch_stats))
    train_kw, engine_kw = {}, {}
    if name == "dispfl":
        engine_kw["screen_idx_for"] = reference_probe_rows(
            jeng, epochs, optim["batch_size"])
        train_kw["masks"] = reference_initial_masks(jeng, gs.params)
    if name == "salientgrads":
        engine_kw["snip_idx_for"] = reference_snip_rows(
            jeng, sparsity.get("itersnip_iterations", 1), optim["batch_size"])
        train_kw["masks"] = masks_from_flax(jax.tree.map(np.asarray,
                                                         jres["masks"]))

    def port_engine(fed_over=None, mesh=None):
        cfg = pcfg
        if fed_over:
            import dataclasses

            cfg = dataclasses.replace(pcfg, fed=dataclasses.replace(
                pcfg.fed, **fed_over))
        trainer = LocalTrainer(create_model(model, tuple(shape), num_classes,
                                            dtype=compute_dtype(precision)),
                               cfg.optim, cpu,
                               torch.Generator().manual_seed(seed),
                               dropout_masks=pmasks, num_classes=num_classes)
        peng = create_engine(name, cfg, pfed, trainer,
                             perms_for=reference_perms(
                                 jeng, nmax, epochs,
                                 fed.get("local_epochs", 1)), mesh=mesh,
                             **engine_kw)
        peng.rerun = lambda: port_engine(fed_over, mesh).train(
            init_state=init, **train_kw)
        if setup is not None:
            setup(jeng, peng)
        return peng

    peng = port_engine()
    peng.rebuild = port_engine
    pres = peng.train(init_state=init, **train_kw)
    return jres, pres, jeng, peng, init


#: Tolerances for runs of several SGD steps held against the reference. A
#: single step from the same weights agrees at the rounding level (each
#: gradient leaf within 1e-3 of its largest entry, test_torch_modules), but
#: where a ReLU input lies within float32 rounding of 0 the unit is active
#: on one side only. At 69^3 the f2-f4 blocks hold 27 positions a channel,
#: so one such unit moves a conv gradient by up to 30% of its largest
#: entry: measured at batch 2 on the test cohort, where the port's float32
#: gradient is within 1e-5 of a float64 one and the reference's is 0.3 from
#: it; the reference itself, from weights perturbed by 1e-6, ends 4 steps
#: 3.5e-2 of the largest weight change away from its own unperturbed run.
#: Later steps carry the difference: weights within 5e-2 of the largest
#: weight change, BN stats within 2e-2 of the leaf's largest entry, train
#: losses rtol 1e-4 and evaluation losses rtol 2e-2 (the largest
#: differences measured on the engine tests' runs: 1.4e-2, 3.3e-3, 1.4e-5
#: and 4.5e-3).
TRAJECTORY = dict(atol_moved=5e-2, bn_rtol=0.0, bn_atol_max=2e-2)
LOSS_RTOL = 1e-4
EVAL_LOSS_RTOL = 2e-2


def assert_state_close(got_p, got_b, ref_p, ref_b, init_p,
                       atol_moved: float = 2e-4, bn_rtol: float = 5e-4,
                       bn_atol_max: float = 0.0):
    """Port state against the reference's (flax trees): every weight within
    ``atol_moved`` of the largest weight change from ``init_p`` (one step:
    the gradients agree to ~1e-4 relative, so the weights agree to that
    fraction of how far training moved them), BN stats within ``bn_rtol``
    (one step: 5e-4, the stem's E[x^2] - E[x]^2) and ``bn_atol_max`` of
    the leaf's largest entry (at least 1e-5). ``ref_b`` None checks the
    weights alone."""
    from neuroimagedisttraining_tpu_torch.weights import params_from_flax

    ref_p, ref_b = params_from_flax(jax.tree.map(np.asarray, ref_p),
                                    jax.tree.map(np.asarray, ref_b or {}))
    moved = max(float((v - init_p[k]).abs().max()) for k, v in ref_p.items())
    assert moved > 0
    for k, v in ref_p.items():
        np.testing.assert_allclose(got_p[k].numpy(), v.numpy(), rtol=0,
                                   atol=atol_moved * moved, err_msg=k)
    for k, v in ref_b.items():
        atol = max(1e-5, bn_atol_max * float(v.abs().max()))
        np.testing.assert_allclose(got_b[k].numpy(), v.numpy(), rtol=bn_rtol,
                                   atol=atol, err_msg=k)


def assert_metrics_close(got: dict, ref: dict,
                         loss_rtol: float = EVAL_LOSS_RTOL) -> None:
    """Evaluation summaries: accuracy and AUC equal (the test rows' logits
    sit far from 0 against the runs' differences), loss within
    ``loss_rtol``."""
    for k in ("acc", "acc_pooled", "auc"):
        assert abs(got[k] - ref[k]) <= 1e-9, (k, got[k], ref[k])
    assert abs(got["loss"] - ref["loss"]) <= loss_rtol * abs(ref["loss"])
