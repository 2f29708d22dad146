"""The port's 3D model zoo held on the CPU against the reference package's
flax models on the same inputs (numpy from a seed, the reference's initial
weights carried across by ``weights.py``): every model's evaluation
forward, one training batch's loss, gradients and BatchNorm stats (the
reference's dropout keep-masks fixed), the weights bridge, the FLOP counts,
GroupNorm at flax's epsilon, and a FedAvg round of the GroupNorm model (no
running stats) and of ResNet3D against the reference's engine.

Volumes: the AlexNet family at 69x145x69, where its three stride-3 pools
leave 1x2x1 positions (at 69^3 a ReLU input within float32 rounding of 0
flips one unit of the 27 positions a channel f2-f4 hold, which moves a conv
gradient by up to 30% of its largest entry: ``torch_port_support``'s
``TRAJECTORY`` note); Tiny3DCNN at 12x14x12 and ResNet3D at 29^3, the
smallest cube its average pool accepts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.config import OptimConfig as JOptim
from neuroimagedisttraining_tpu.core.trainer import (
    ClientState, LocalTrainer as JTrainer,
)
from neuroimagedisttraining_tpu.data.synthetic import generate_synthetic_abcd
from neuroimagedisttraining_tpu.models import create_model as jcreate
from neuroimagedisttraining_tpu.ops import flops as JFLOPS
from neuroimagedisttraining_tpu_torch.config import OptimConfig
from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
from neuroimagedisttraining_tpu_torch.models import (
    MODELS_2D, MODELS_3D, create_model,
)
from neuroimagedisttraining_tpu_torch.models.neuro3d import GroupNorm3d
from neuroimagedisttraining_tpu_torch.ops import flops as PFLOPS
from neuroimagedisttraining_tpu_torch.ops.fused_update import MAX_LEAVES
from neuroimagedisttraining_tpu_torch.weights import (
    params_from_flax, params_to_flax,
)

from torch_port_support import (
    LOSS_RTOL, TRAJECTORY, assert_state_close, fixed_dropout,
    model_dropout_masks, run_engine_pair, torch_threads,
)

CPU = torch.device("cpu")
SHAPES = {"3dcnn": (69, 145, 69), "3dcnn_gn": (69, 145, 69),
          "3dcnn_deeper": (69, 145, 69), "3dcnn_regression": (69, 145, 69),
          "3dcnn_tiny": (12, 14, 12), "resnet3d": (29, 29, 29)}
#: leaves of each model's parameter tree (the reference's, counted with
#: jax.eval_shape): one fused_sgd table each
LEAVES = {"3dcnn": 24, "3dcnn_gn": 24, "3dcnn_deeper": 28,
          "3dcnn_regression": 24, "3dcnn_tiny": 12, "resnet3d": 31}
STEM_MODELS = ("3dcnn", "3dcnn_gn", "3dcnn_deeper", "3dcnn_regression")


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads(2):
        yield


def _batch(shape, seed=2, n=2):
    X = generate_synthetic_abcd(num_subjects=n, shape=shape, num_sites=1,
                                seed=seed)["X"]
    return X, np.arange(n, dtype=np.int32) % 2


_REFS: dict = {}


def _reference(name):
    """The reference's model, its initial (params, batch_stats), its
    evaluation outputs and one training batch's (loss, grads, stats), run
    op by op (eagerly), once per model."""
    if name not in _REFS:
        shape = SHAPES[name]
        jt = JTrainer(jcreate(name, num_classes=1, remat=False), JOptim(),
                      num_classes=1)
        cs = jt.init_client_state(jax.random.key(0),
                                  jnp.zeros((1,) + shape))
        jp = jax.tree.map(np.asarray, cs.params)
        jb = jax.tree.map(np.asarray, cs.batch_stats)
        X, y = _batch(shape)
        out = jt._apply(jp, jb, jt._prep(jnp.asarray(X)), train=False)[0]
        jmasks, pmasks = model_dropout_masks(name, shape, 2, seed=3)
        cs = ClientState(params=jp, batch_stats=jb, opt_state=None,
                         rng=jax.random.key(1))
        with fixed_dropout(jmasks):
            loss, grads, new_b, _ = jt.loss_and_grad(cs, jnp.asarray(X),
                                                     jnp.asarray(y))
        _REFS[name] = dict(
            jt=jt, jp=jp, jb=jb, X=X, y=y, pmasks=pmasks,
            out=jax.tree.map(np.asarray, out), loss=float(loss),
            grads=jax.tree.map(np.asarray, grads),
            new_b=jax.tree.map(np.asarray, new_b))
    return _REFS[name]


def _port(name, masks=None):
    model = create_model(name, SHAPES[name])
    return LocalTrainer(model, OptimConfig(), CPU,
                        torch.Generator().manual_seed(0),
                        dropout_masks=masks)


def _outputs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name", list(SHAPES))
def test_weights_round_trip(name):
    """flax -> port -> flax returns the identical trees; the port's names
    and shapes are exactly the module's parameters and buffers (GroupNorm's
    ``scale``/``bias``, the bias-free convs, ResNet3D's nested names, the
    GroupNorm model's empty ``batch_stats``), and the leaf counts are the
    reference's."""
    ref = _reference(name)
    params, bstats = params_from_flax(ref["jp"], ref["jb"])
    model = create_model(name, SHAPES[name])
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert {k: tuple(v.shape) for k, v in bstats.items()} == \
        {k: tuple(v.shape) for k, v in model.named_buffers()}
    assert len(params) == LEAVES[name] == len(jax.tree.leaves(ref["jp"]))
    assert LEAVES[name] <= MAX_LEAVES  # one fused_sgd table
    assert (len(bstats) == 0) == (name == "3dcnn_gn")
    back_p, back_b = params_to_flax(params, bstats, ref["jp"], ref["jb"])
    for a, b in zip(jax.tree.leaves(back_p) + jax.tree.leaves(back_b),
                    jax.tree.leaves(ref["jp"]) + jax.tree.leaves(ref["jb"])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(SHAPES))
def test_eval_forward_matches(name):
    """Evaluation-mode outputs (BatchNorm on running stats, no dropout) on
    raw uint8 volumes, every output of the model (the deeper model's pair,
    the regression model's squeezed logits and NDHWC pooled features,
    ResNet3D's penultimate layer): fp32 sums in other orders, rtol 1e-4 and
    1e-4 of the output's largest entry."""
    ref = _reference(name)
    params, bstats = params_from_flax(ref["jp"], ref["jb"])
    port = _port(name)
    out = torch.func.functional_call(
        port.model, (params, bstats),
        (LocalTrainer._prep(torch.from_numpy(ref["X"])),), {"train": False})
    got, want = _outputs(out), _outputs(ref["out"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_bottleneck_resnet_eval_forward_matches():
    """ResNet3D_l3 with bottleneck blocks (expansion 4; the reference's
    option, which its registry does not name): the weights bridge and the
    evaluation forward against the flax model at 29^3, as above."""
    from neuroimagedisttraining_tpu.models.neuro3d import (
        ResNet3D_l3 as JResNet,
    )
    from neuroimagedisttraining_tpu_torch.models import (
        ResNet3D_l3, resnet_flat_features,
    )

    shape = SHAPES["resnet3d"]
    jm = JResNet(num_classes=1, block="bottleneck")
    X, _ = _batch(shape)
    x = jnp.asarray(X, jnp.float32)[..., None]
    v = jm.init(jax.random.key(0), x, train=False)
    want = jm.apply(v, x, train=False)
    params, bstats = params_from_flax(jax.tree.map(np.asarray, v["params"]),
                                      jax.tree.map(np.asarray,
                                                   v["batch_stats"]))
    pm = ResNet3D_l3(flat_features=resnet_flat_features(shape),
                     block="bottleneck")
    assert {k: tuple(t.shape) for k, t in params.items()} == \
        {k: tuple(t.shape) for k, t in pm.named_parameters()}
    got = torch.func.functional_call(
        pm, (params, bstats),
        (LocalTrainer._prep(torch.from_numpy(X)),), {"train": False})
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("name,fast_stem", [
    *[(n, f) for n in STEM_MODELS for f in (False, True)],
    ("3dcnn_tiny", False), ("resnet3d", False)])
def test_loss_and_grad_matches(name, fast_stem, monkeypatch):
    """One training-mode batch with the reference's dropout keep-masks:
    loss rtol 1e-4 (fp32 sums in other orders through up to seven conv
    layers, against the reference run op by op: measured 5.2e-5 on the
    flagship model, whose loss is 0.150), each gradient leaf within
    1e-3 of its largest entry or 1e-5 of the model's largest gradient (a
    conv bias feeding a norm has an exact gradient of 0: both sides hold
    rounding noise), the new running stats rtol 5e-4 (flax's E[x^2] -
    E[x]^2 on the stem's raw intensities). The AlexNet family's stem runs
    both ways: through ``ops/stemconv.py`` (its plain version on the CPU)
    and through autograd."""
    monkeypatch.setenv("NIDT_FAST_STEM", "1" if fast_stem else "0")
    ref = _reference(name)
    params, bstats = params_from_flax(ref["jp"], ref["jb"])
    port = _port(name, ref["pmasks"])
    if name in STEM_MODELS:
        assert port.model.f0.fast_stem is fast_stem
    loss, grads, new_b = port.loss_and_grad(
        params, bstats, torch.from_numpy(ref["X"]),
        torch.from_numpy(ref["y"]))
    assert float(loss) == pytest.approx(ref["loss"], rel=1e-4)
    ref_g, ref_b = params_from_flax(ref["grads"], ref["new_b"])
    gmax = max(float(g.abs().max()) for g in ref_g.values())
    for k, g in ref_g.items():
        atol = max(1e-3 * float(g.abs().max()), 1e-5 * gmax)
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=0,
                                   atol=atol, err_msg=k)
    assert set(new_b) == set(ref_b)
    for k, v in ref_b.items():
        np.testing.assert_allclose(new_b[k].numpy(), v.numpy(), rtol=5e-4,
                                   atol=1e-5, err_msg=k)


def test_regression_model_at_batch_one():
    """The regression model squeezes its logits: a scalar at batch 1 (as the
    reference's), which the trainer's loss, gradient and evaluation take
    (an evaluation chunk of one row included)."""
    shape = (69, 69, 69)
    model = create_model("3dcnn_regression", shape)
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    bstats = {k: v.clone() for k, v in model.named_buffers()}
    X = torch.from_numpy(_batch(shape, n=3)[0])
    y = torch.tensor([0, 1, 1], dtype=torch.int32)
    out = torch.func.functional_call(
        model, (params, bstats), (LocalTrainer._prep(X[:1]),),
        {"train": False})
    assert out[0].dim() == 0 and out[1].shape == (1, 1, 1, 1, 128)
    tr = LocalTrainer(model, OptimConfig(), CPU,
                      torch.Generator().manual_seed(0))
    loss, grads, _ = tr.loss_and_grad(params, bstats, X[:1], y[:1])
    assert torch.isfinite(loss) and set(grads) == set(params)
    m = tr.evaluate(params, bstats, X, y, torch.ones(3, dtype=torch.bool),
                    batch_size=2)
    assert m["scores"].shape == (3,) and float(m["test_total"]) == 3.0


def test_group_norm_matches_flax_at_its_epsilon():
    """``GroupNorm3d`` against flax's ``nn.GroupNorm(num_groups=min(32, C))``
    on activations whose group variance is near epsilon (so 1e-5 and flax's
    1e-6 differ): float32 and bf16 (statistics in float32, output rounded),
    rtol 1e-5 / one bf16 rounding; no running stats."""
    import flax.linen as fnn

    rng = np.random.default_rng(4)
    for c in (8, 64):
        # centred (no cancellation in E[x^2] - E[x]^2), variance 4e-6
        x = (2e-3 * rng.standard_normal((2, 5, 6, 4, c))).astype(np.float32)
        scale = rng.standard_normal(c).astype(np.float32)
        bias = rng.standard_normal(c).astype(np.float32)
        for jdt, pdt, tol in ((jnp.float32, torch.float32, 1e-5),
                              (jnp.bfloat16, torch.bfloat16, 8e-3)):
            mod = fnn.GroupNorm(num_groups=min(32, c), dtype=jdt)
            v = {"params": {"scale": scale, "bias": bias}}
            want = np.asarray(mod.apply(v, jnp.asarray(x).astype(jdt)),
                              np.float32)
            gn = GroupNorm3d(c, dtype=pdt)
            assert gn.groups == min(32, c) and gn.eps == 1e-6
            assert not list(gn.buffers())
            with torch.no_grad():
                gn.weight.copy_(torch.from_numpy(scale))
                gn.bias.copy_(torch.from_numpy(bias))
                xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).to(pdt)
                got = gn(xt, True).float().permute(0, 2, 3, 4, 1).numpy()
            np.testing.assert_allclose(got, want, rtol=tol,
                                       atol=tol * np.abs(want).max())
            # epsilon 1e-5 would be visibly off on these activations
            wrong = GroupNorm3d(c, eps=1e-5, dtype=torch.float32)
            if pdt == torch.float32:
                with torch.no_grad():
                    wrong.weight.copy_(torch.from_numpy(scale))
                    wrong.bias.copy_(torch.from_numpy(bias))
                    off = wrong(xt.float(), True).permute(0, 2, 3, 4, 1)
                assert np.abs(off.numpy() - want).max() > 1e-2


@pytest.mark.parametrize("name", list(SHAPES))
def test_flops_match_reference(name):
    """``stat_info``'s FLOP counts: the port's counter (meta-device forward)
    equals the reference's (captured intermediates) on the same model and
    volume, dense and with a mask density on every kernel, at the
    reference's ABCD volume too for the AlexNet family."""
    shapes = [SHAPES[name]] + ([(121, 145, 121)] if name in STEM_MODELS
                               else [])
    for shape in shapes:
        jm = jcreate(name, num_classes=1, remat=False)
        x1 = jnp.zeros((1,) + shape + (1,))
        jv = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)},
            x1, train=False))
        pm = create_model(name, shape)
        dens = {k: 0.25 + 0.5 * (i % 2) for i, (k, v) in
                enumerate(pm.named_parameters()) if v.dim() >= 2}
        jdens = {k.replace(".", "/").replace("weight", "kernel"): d
                 for k, d in dens.items()}
        for pd, jd in ((None, None), (dens, jdens)):
            want = JFLOPS.count_training_flops_per_sample(
                jm, jv["params"], x1, jd, batch_stats=jv.get("batch_stats"))
            got = PFLOPS.count_training_flops_per_sample(pm, shape, pd)
            assert got == pytest.approx(want, rel=1e-12), (shape, pd)


@pytest.mark.parametrize("name,cls", [
    ("3DCNN", "AlexNet3D_Dropout"), ("alexnet3d", "AlexNet3D_Dropout"),
    ("3DCNN_gn", "AlexNet3D_Dropout"),
    ("alexnet3d_dropout_gn", "AlexNet3D_Dropout"),
    ("3dcnn_deeper", "AlexNet3D_Deeper_Dropout"),
    ("alexnet3d_dropout_regression", "AlexNet3D_Dropout_Regression"),
    ("tiny3dcnn", "Tiny3DCNN"), ("resnet_l3", "ResNet3D_l3"),
    ("ResNet3D_l3", "ResNet3D_l3")])
def test_create_model_names(name, cls):
    """The reference's six 3D names and their aliases, case-blind; the
    GroupNorm name builds ``gn`` norms and no running stats; ``fc1``'s
    width follows the volume (512 for the deeper model at 121x145x121)."""
    shape = SHAPES.get(name.lower(), (121, 145, 121))
    model = create_model(name, shape)
    assert type(model).__name__ == cls
    gn = "gn" in name.lower()
    assert hasattr(model.f0, "gn") == gn if hasattr(model, "f0") else True
    if name == "3dcnn_deeper":
        assert create_model(name, (121, 145, 121)).fc1.weight.shape[1] == 512


@pytest.mark.parametrize("name", ["nope", "resnet50"])
def test_2d_and_unknown_models_raise(name):
    """A name neither package has is unknown: it raises, naming every
    model the port has, 3D and 2D (the DARTS family among them)."""
    with pytest.raises(ValueError) as e:
        create_model(name, (69, 69, 69))
    for m in (*MODELS_3D, *MODELS_2D, "darts", "fednas_v1", "darts_search"):
        assert m in str(e.value)


@pytest.mark.parametrize("name", ["darts", "darts_v2", "fednas_v1",
                                  "darts_search"])
def test_darts_names_build_the_reference_class(name):
    """The DARTS names build the port's model of the reference's class at
    the reference's defaults: the fixed networks of its genotypes at C=36
    and 20 cells without the auxiliary head, the search supernet at C=16,
    8 cells of 4 steps, softmax mixture."""
    from neuroimagedisttraining_tpu.models import create_model as jcreate

    ref = jcreate(name, num_classes=10)
    got = create_model(name, (32, 32, 3), 10)
    assert type(got).__name__ == type(ref).__name__
    assert got.input_rank == 4
    assert (got.c, got.layers) == (ref.c, ref.layers)
    if type(ref).__name__ == "DartsSearchNet":
        assert (got.steps, got.multiplier, got.gumbel) == (
            ref.steps, ref.multiplier, ref.gumbel)
    else:
        assert tuple(got.genotype) == tuple(ref.genotype)
        assert got.auxiliary == ref.auxiliary


@pytest.mark.parametrize("name", [
    "resnet18", "customized_resnet18", "original_resnet18", "tiny_resnet18",
    "resnet18_ip", "resnet_ip", "vgg11", "vgg16", "cnn_cifar10",
    "cnn_cifar100", "simple-cnn", "cnn_cifar10_bn", "cnn_cifar100_bn", "cnn",
    "cnn_originalfedavg", "cnn_dropout", "femnist-cnn", "lenet5",
    "lenet5_cifar", "cnn_cifar10_meta", "cnn_meta", "resnet_meta",
    "resnet20_meta"])
def test_2d_model_names_build_the_reference_class(name):
    """Every 2D name of the reference's ``create_model`` but the DARTS
    family builds the port's model of the reference's class (the ResNet-18
    variants' norm kinds and pool included), for 32x32x3 images."""
    from neuroimagedisttraining_tpu.models import create_model as jcreate

    ref = jcreate(name, num_classes=10)
    got = create_model(name, (32, 32, 3), 10)
    assert type(got).__name__ == type(ref).__name__
    assert got.input_rank == 4
    if type(ref).__name__ == "ResNet18":
        kind = type(got.bn1).__name__
        assert {"IPNorm": "ipbn"}.get(kind) or type(got.bn1.norm).__name__ \
            == {"gn": "GroupNorm3d", "bn": "BatchNorm3d"}.get(ref.norm)
        assert got.adaptive_pool == ref.adaptive_pool


_ENGINE_RUNS: dict = {}


@pytest.fixture(scope="module")
def fedavg_runs(tmp_path_factory):
    def run(name):
        if name not in _ENGINE_RUNS:
            from torch_port_support import four_client_federation

            shape = SHAPES[name] if name == "resnet3d" else (69, 69, 69)
            X, y, tr, te = four_client_federation()
            if shape != (69, 69, 69):
                X = generate_synthetic_abcd(num_subjects=16, shape=shape,
                                            num_sites=4, seed=0)["X"]
            _ENGINE_RUNS[name] = run_engine_pair(
                "fedavg", (X, y, tr, te),
                dict(lr=0.01, batch_size=2, epochs=1, fused_update=True),
                dict(client_num_in_total=4, comm_round=1,
                     frequency_of_the_test=1),
                tmp_path_factory.mktemp(name), shape=shape, model=name)
        return _ENGINE_RUNS[name]
    return run


@pytest.mark.parametrize("name", ["3dcnn_gn", "resnet3d"])
def test_fedavg_round_matches_reference(fedavg_runs, name):
    """One FedAvg round (4 clients, 2 steps each, the final fine-tune) of the
    GroupNorm model (empty ``batch_stats`` through the engine, FedAvg's
    stat average and the fine-tune) and of ResNet3D against the reference's
    engine on the same federation, weights, permutations and keep-masks:
    global weights and stats at ``TRAJECTORY``, the round loss rtol 1e-4."""
    jres, pres, _, _, init = fedavg_runs(name)
    init_p, _ = init
    assert (len(pres["batch_stats"]) == 0) == (name == "3dcnn_gn")
    assert_state_close(pres["params"], pres["batch_stats"], jres["params"],
                       jres["batch_stats"], init_p, **TRAJECTORY)
    assert [h["round"] for h in pres["history"]] == \
        [h["round"] for h in jres["history"]]
    assert pres["history"][0]["train_loss"] == pytest.approx(
        jres["history"][0]["train_loss"], rel=LOSS_RTOL)
