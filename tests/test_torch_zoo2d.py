"""The port's 2D model zoo held on the CPU against the reference package's
flax models on the same inputs (images from a seed, the reference's initial
weights carried across by ``weights.py``): every 2D model's evaluation
forward, one training batch's loss, gradients and BatchNorm statistics
(``CNN_DropOut``'s keep-masks fixed), the weights bridge both ways,
``ResNetMeta`` at full and reduced widths, ``CNNCifarMeta`` with and
without masks, ResNet-18 under ``bf16_mixed`` and the FLOP counts.

Images are 32x32x3 (CIFAR); the MNIST-family models also run on [B, 28,
28] batches, which both packages give a channel. Batch 4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.config import OptimConfig as JOptim
from neuroimagedisttraining_tpu.core.trainer import (
    ClientState, LocalTrainer as JTrainer,
)
from neuroimagedisttraining_tpu.models import create_model as jcreate
from neuroimagedisttraining_tpu.ops import flops as JFLOPS
from neuroimagedisttraining_tpu_torch.config import OptimConfig
from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
from neuroimagedisttraining_tpu_torch.models import create_model
from neuroimagedisttraining_tpu_torch.ops import flops as PFLOPS
from neuroimagedisttraining_tpu_torch.ops.fused_update import MAX_LEAVES
from neuroimagedisttraining_tpu_torch.weights import (
    masks_from_flax, params_from_flax, params_to_flax,
)

from torch_port_support import fixed_dropout, torch_threads

CPU = torch.device("cpu")
CIFAR = (32, 32, 3)
MNIST = (28, 28)
#: every 2D name of the reference's create_model but the DARTS family, by
#: sample shape: [H, W, C] images, or [H, W] for the MNIST family's
#: single-channel batches
CASES = {n: (n, CIFAR) for n in (
    "resnet18", "original_resnet18", "tiny_resnet18", "resnet18_ip",
    "vgg11", "vgg16", "cnn_cifar10", "cnn_cifar10_bn", "cnn", "cnn_dropout",
    "lenet5", "lenet5_cifar", "cnn_meta", "resnet_meta")}
CASES.update({f"{n}_mnist": (n, MNIST) for n in ("cnn", "cnn_dropout",
                                                 "lenet5")})
#: leaves of each model's parameter tree (the reference's): resnet18's 62,
#: vgg11's 34, vgg16's and resnet_meta's 54 take two fused_sgd tables
LEAVES = {"resnet18": 62, "original_resnet18": 62, "tiny_resnet18": 62,
          "resnet18_ip": 62, "vgg11": 34, "vgg16": 54, "cnn_cifar10": 10,
          "cnn_cifar10_bn": 14, "cnn": 8, "cnn_dropout": 8, "lenet5": 8,
          "lenet5_cifar": 10, "cnn_meta": 3, "resnet_meta": 54}
B = 4
NUM_CLASSES = 10


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads(2):
        yield


def _images(shape, seed=2, n=B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, *shape)).astype(np.float32),
            (np.arange(n) % NUM_CLASSES).astype(np.int32))


def _dropout_masks(name, shape, seed=3):
    """``CNN_DropOut``'s two keep-masks at batch ``B``: the reference's by
    module name (NHWC), the port's in order (flattened NHWC)."""
    if name != "cnn_dropout":
        return {}, None
    from neuroimagedisttraining_tpu_torch.models import cnn_dropout_flat

    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    m0 = rng.random((B, (h - 4) // 2, (w - 4) // 2, 64)) < 0.75
    m1 = rng.random((B, 128)) < 0.5
    return ({"Dropout_0": m0, "Dropout_1": m1},
            (torch.from_numpy(m0.reshape(B, cnn_dropout_flat(shape))),
             torch.from_numpy(m1)))


_REFS: dict = {}


def _reference(case):
    """The reference's model, its initial (params, batch_stats), its
    evaluation logits and one training batch's (loss, grads, stats), each
    under ``jax.jit``, once per case."""
    if case not in _REFS:
        name, shape = CASES[case]
        jt = JTrainer(jcreate(name, num_classes=NUM_CLASSES), JOptim(),
                      num_classes=NUM_CLASSES)
        cs = jt.init_client_state(jax.random.key(0),
                                  jnp.zeros((1,) + shape))
        jp = jax.tree.map(np.asarray, cs.params)
        jb = jax.tree.map(np.asarray, cs.batch_stats)
        X, y = _images(shape)
        out = jax.jit(lambda p, b, x: jt._apply(p, b, jt._prep(x),
                                                train=False)[0])(jp, jb, X)
        jmasks, pmasks = _dropout_masks(name, shape)
        cs = ClientState(params=jp, batch_stats=jb, opt_state=None,
                         rng=jax.random.key(1))
        with fixed_dropout(jmasks):
            loss, grads, new_b, _ = jax.jit(jt.loss_and_grad)(cs, X, y)
        _REFS[case] = dict(
            jp=jp, jb=jb, X=X, y=y, pmasks=pmasks, out=np.asarray(out),
            loss=float(loss), grads=jax.tree.map(np.asarray, grads),
            new_b=jax.tree.map(np.asarray, new_b))
    return _REFS[case]


def _port(case, masks=None, precision="fp32"):
    from neuroimagedisttraining_tpu_torch.core.optim import compute_dtype

    name, shape = CASES[case]
    model = create_model(name, shape, NUM_CLASSES,
                         dtype=compute_dtype(precision))
    return LocalTrainer(model, OptimConfig(precision=precision), CPU,
                        torch.Generator().manual_seed(0),
                        dropout_masks=masks, num_classes=NUM_CLASSES)


@pytest.mark.parametrize("case", list(CASES))
def test_weights_round_trip(case):
    """flax -> port -> flax returns the identical trees; the port's names
    and shapes are exactly the model's parameters and buffers (the 2D
    ResNet's ``bn1/norm`` and ``ipbn``'s ``bn1/scale``, ``cnn_meta``'s
    top-level kernels, ``resnet_meta``'s BatchNorms without scale or bias),
    and the leaf counts are the reference's."""
    ref = _reference(case)
    name, shape = CASES[case]
    params, bstats = params_from_flax(ref["jp"], ref["jb"])
    model = create_model(name, shape, NUM_CLASSES)
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert {k: tuple(v.shape) for k, v in bstats.items()} == \
        {k: tuple(v.shape) for k, v in model.named_buffers()}
    assert len(params) == LEAVES[name] == len(jax.tree.leaves(ref["jp"]))
    assert -(-LEAVES[name] // MAX_LEAVES) == (2 if LEAVES[name] > 32 else 1)
    back_p, back_b = params_to_flax(params, bstats, ref["jp"], ref["jb"])
    for a, b in zip(jax.tree.leaves(back_p) + jax.tree.leaves(back_b),
                    jax.tree.leaves(ref["jp"]) + jax.tree.leaves(ref["jb"])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_eval_forward_matches(case):
    """Evaluation-mode logits (BatchNorm on running stats, ``ipbn`` on the
    batch's own, no dropout) on NHWC float images turned NCHW by the
    trainer: float32 sums in other orders, rtol 1e-4 and 1e-4 of the
    largest logit."""
    ref = _reference(case)
    params, bstats = params_from_flax(ref["jp"], ref["jb"])
    port = _port(case)
    got = port.apply(params, bstats, port._prep(torch.from_numpy(ref["X"]),
                                                port.input_rank), False)
    assert tuple(got.shape) == ref["out"].shape
    np.testing.assert_allclose(got.detach().numpy(), ref["out"], rtol=1e-4,
                               atol=1e-4 * np.abs(ref["out"]).max())


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grad_matches(case):
    """One training-mode batch (``CNN_DropOut`` under the reference's
    keep-masks): softmax CE rtol 1e-4, each gradient leaf within 1e-2 of
    its L2 norm (the reference's own gradients move by up to 1.4e-2 of a
    leaf's norm when its weights are perturbed by 1e-6 relative: ReLU
    inputs at the rounding level, whose flips a BatchNorm after few
    positions amplifies; the port's measured up to 4.6e-3) or 1e-5 of the
    largest leaf's norm (a conv bias before a norm has an exact gradient of
    0: both sides hold rounding noise), the new running stats rtol 5e-4
    (flax's E[x^2] - E[x]^2)."""
    ref = _reference(case)
    params, bstats = params_from_flax(ref["jp"], ref["jb"])
    port = _port(case, ref["pmasks"])
    loss, grads, new_b = port.loss_and_grad(
        params, bstats, torch.from_numpy(ref["X"]),
        torch.from_numpy(ref["y"]))
    assert float(loss) == pytest.approx(ref["loss"], rel=1e-4)
    ref_g, ref_b = params_from_flax(ref["grads"], ref["new_b"])
    assert set(grads) == set(ref_g)
    floor = 1e-5 * max(float(g.norm()) for g in ref_g.values())
    for k, g in ref_g.items():
        err = float((grads[k] - g).norm())
        assert err <= max(1e-2 * float(g.norm()), floor), (k, err)
    assert set(new_b) == set(ref_b)
    for k, v in ref_b.items():
        np.testing.assert_allclose(new_b[k].numpy(), v.numpy(), rtol=5e-4,
                                   atol=1e-5, err_msg=k)


def _flax_apply(model, variables, x, train, **kw):
    if train and variables.get("batch_stats"):
        out, mut = model.apply(variables, x, train=True,
                               mutable=["batch_stats"], **kw)
        return out, mut["batch_stats"]
    return model.apply(variables, x, train=train, **kw), None


@pytest.mark.parametrize("widths", ["full", "reduced"])
def test_resnet_meta_widths(widths):
    """``ResNetMeta`` at full width and at reduced widths (stage and mid
    ids into ``CHANNEL_SCALE``: some channels masked off, rounding half to
    even): evaluation logits and a training forward's logits and new
    running stats (momentum 0.99) against the flax model, rtol 1e-4 and
    1e-4 of the largest entry."""
    from neuroimagedisttraining_tpu.models.meta import ResNetMeta as JMeta

    ids = ({} if widths == "full" else
           {"stage_ids": [3, 10, 17, 0], "mid_ids": [30, 5, 12]})
    X, _ = _images(CIFAR, seed=5)
    jm = JMeta(num_classes=NUM_CLASSES)
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(0), X, train=False))
    params, bstats = params_from_flax(v["params"], v["batch_stats"])
    pm = create_model("resnet_meta", CIFAR, NUM_CLASSES)
    xt = LocalTrainer._prep(torch.from_numpy(X), 4)
    for train in (False, True):
        want, want_b = _flax_apply(jm, v, X, train,
                                   **{k: jnp.asarray(i) for k, i in
                                      ids.items()})
        new_b = {k: t.clone() for k, t in bstats.items()}
        got = torch.func.functional_call(pm, (params, new_b), (xt,),
                                         {"train": train, **ids})
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
        if train:
            _, ref_b = params_from_flax({}, jax.tree.map(np.asarray, want_b))
            for k, r in ref_b.items():
                np.testing.assert_allclose(new_b[k].numpy(), r.numpy(),
                                           rtol=1e-4, atol=1e-6, err_msg=k)


def test_cnn_meta_with_and_without_masks():
    """``CNNCifarMeta``'s forward without masks and with binary masks on
    its three kernels (carried across as the kernels are): logits and the
    gradient of a sum of them against the flax model, rtol 1e-4 and 1e-4
    of the largest entry; masked entries get a zero gradient."""
    from neuroimagedisttraining_tpu.models.meta import CNNCifarMeta as JMeta

    X, _ = _images(CIFAR, seed=6)
    jm = JMeta(num_classes=NUM_CLASSES)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0), X)["params"])
    rng = np.random.default_rng(7)
    jmasks = {k.removesuffix("_kernel"): (rng.random(v.shape) < 0.5)
              .astype(np.float32) for k, v in jp.items()}
    params, _ = params_from_flax(jp, {})
    pmasks = {k.removesuffix("_weight"): m for k, m in masks_from_flax(
        {f"{k}_kernel": m for k, m in jmasks.items()}).items()}
    pm = create_model("cnn_meta", CIFAR, NUM_CLASSES)
    xt = LocalTrainer._prep(torch.from_numpy(X), 4)
    for jmk, pmk in ((None, None), (jmasks, pmasks)):
        def jloss(p):
            return jnp.sum(jm.apply({"params": p}, X, masks=jmk) ** 2)
        want_g = jax.grad(jloss)(jp)
        want = np.asarray(jm.apply({"params": jp}, X, masks=jmk))
        leaves = {k: t.clone().requires_grad_(True) for k, t in
                  params.items()}
        got = torch.func.functional_call(pm, leaves, (xt,),
                                         {"train": True, "masks": pmk})
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
        grads = dict(zip(leaves, torch.autograd.grad(
            (got ** 2).sum(), list(leaves.values()))))
        ref_g, _ = params_from_flax(jax.tree.map(np.asarray, want_g), {})
        for k, g in ref_g.items():
            np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=1e-4,
                                       atol=1e-4 * float(g.abs().max()),
                                       err_msg=k)
            if pmk is not None:
                dead = pmk[k.removesuffix("_weight")] == 0
                assert not grads[k][dead].any()


def test_resnet18_bf16_mixed_at_the_reference_pin():
    """ResNet-18 (GroupNorm) under ``bf16_mixed``: the port's bfloat16
    training batch against the reference's at the reference's own bf16 pin
    (the loss within 2e-3 absolute, the weights after one SGD step at lr
    0.01 within 5e-3 absolute; measured 1.2e-3 and 2.2e-4), and its
    gradients no farther from the reference's bf16 ones than those are
    from the reference's float32 ones (L2 over every leaf: bf16 rounds in
    other places in the two frameworks); loss and gradients float32."""
    ref = _reference("resnet18")
    params, bstats = params_from_flax(ref["jp"], ref["jb"])
    jt = JTrainer(jcreate("resnet18", num_classes=NUM_CLASSES,
                          dtype=jnp.bfloat16),
                  JOptim(precision="bf16_mixed"), num_classes=NUM_CLASSES)
    cs = ClientState(params=ref["jp"], batch_stats=ref["jb"],
                     opt_state=None, rng=jax.random.key(1))
    # op by op: under jit XLA keeps excess precision inside its fusions
    jloss, jgrads, _, _ = jt.loss_and_grad(cs, jnp.asarray(ref["X"]),
                                           jnp.asarray(ref["y"]))
    port = _port("resnet18", precision="bf16_mixed")
    loss, grads, _ = port.loss_and_grad(params, bstats,
                                        torch.from_numpy(ref["X"]),
                                        torch.from_numpy(ref["y"]))
    assert loss.dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert abs(float(loss) - float(jloss)) < 2e-3
    g16, _ = params_from_flax(jax.tree.map(np.asarray, jgrads), {})
    g32, _ = params_from_flax(ref["grads"], {})
    lr = 0.01
    for k, g in g16.items():
        np.testing.assert_allclose((params[k] - lr * grads[k]).numpy(),
                                   (params[k] - lr * g).numpy(), rtol=0,
                                   atol=5e-3, err_msg=k)

    def dist(a, b):
        return float(torch.cat([(a[k] - b[k]).reshape(-1) for k in b]).norm())
    assert dist(grads, g16) <= dist(g16, g32)


@pytest.mark.parametrize("case", [c for c in CASES
                                  if CASES[c][0] not in ("cnn_meta",
                                                         "resnet_meta")])
def test_flops_match_reference(case):
    """``stat_info``'s FLOP counts: the port's counter equals the
    reference's on the same model and image, dense and with a mask density
    on every kernel (resnet18: 1,110,845,440 inference FLOPs at
    32x32x3)."""
    name, shape = CASES[case]
    jm = jcreate(name, num_classes=NUM_CLASSES)
    x1 = jnp.zeros((1,) + shape)
    jv = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        x1, train=False))
    pm = create_model(name, shape, NUM_CLASSES)
    dens = {k: 0.25 + 0.5 * (i % 2) for i, (k, v) in
            enumerate(pm.named_parameters()) if v.dim() >= 2}
    jdens = {k.replace(".", "/").replace("weight", "kernel"): d
             for k, d in dens.items()}
    for pd, jd in ((None, None), (dens, jdens)):
        want = JFLOPS.count_training_flops_per_sample(
            jm, jv["params"], x1, jd, batch_stats=jv.get("batch_stats"))
        got = PFLOPS.count_training_flops_per_sample(pm, shape, pd)
        assert got == pytest.approx(want, rel=1e-12), pd
    if name == "resnet18":
        assert PFLOPS.count_inference_flops(pm, shape) == 1_110_845_440


def test_meta_flops_differ_from_the_reference_counter():
    """The two models whose FLOPs the port counts where the reference's
    counter does not (ROADMAP Queue 3): ``cnn_meta``'s top-level kernels,
    for which the reference raises, are counted at their conv modules'
    outputs (24,135,680 inference FLOPs at 32x32x3); for ``resnet_meta``
    the reference counts its hypernetworks' dense kernels alone
    (1,165,888), and the port adds the generated convolutions that run
    (6,889,472)."""
    def jcount(name):
        jm = jcreate(name, num_classes=NUM_CLASSES)
        x1 = jnp.zeros((1,) + CIFAR)
        jv = jax.eval_shape(lambda: jm.init(jax.random.key(0), x1,
                                            train=False))
        return JFLOPS.count_inference_flops(
            jm, jv["params"], x1, batch_stats=jv.get("batch_stats"))

    with pytest.raises(ValueError, match="meta_conv1_kernel"):
        jcount("cnn_meta")
    cm = create_model("cnn_meta", CIFAR, NUM_CLASSES)
    assert PFLOPS.count_inference_flops(cm, CIFAR) == 24_135_680
    rm = create_model("resnet_meta", CIFAR, NUM_CLASSES)
    assert jcount("resnet_meta") == 1_165_888
    dense = sum(2 * v.numel() for k, v in rm.named_parameters()
                if v.dim() == 2)
    assert dense == 1_165_888
    assert PFLOPS.count_inference_flops(rm, CIFAR) == 1_165_888 + 6_889_472


def test_metanet_matches():
    """``MetaNet``, the hypernetwork from a conv mask to a conv weight of
    its shape: the port's on a mask in its OIHW layout against the flax
    model on the same mask in HWIO (the flat order is the reference's),
    the weight carried back to HWIO; rtol 1e-5 and 1e-5 of its largest
    entry."""
    from neuroimagedisttraining_tpu.models.meta import MetaNet as JMetaNet
    from neuroimagedisttraining_tpu_torch.models import MetaNet

    mask = (np.random.default_rng(8).random((3, 3, 4, 8)) < 0.5).astype(
        np.float32)
    jm = JMetaNet()
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(0), mask))
    want = np.asarray(jm.apply(v, mask))
    params, _ = params_from_flax(v["params"], {})
    pm = MetaNet(mask.size)
    assert {k: tuple(t.shape) for k, t in params.items()} == \
        {k: tuple(t.shape) for k, t in pm.named_parameters()}
    got = torch.func.functional_call(
        pm, params, (torch.from_numpy(mask.transpose(3, 2, 0, 1).copy()),))
    np.testing.assert_allclose(got.detach().numpy().transpose(2, 3, 1, 0),
                               want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
