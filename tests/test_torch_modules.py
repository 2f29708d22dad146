"""The port's data, weights bridge, model, loss and trainer pieces, held
on the CPU against the reference package on the same inputs (numpy from a
seed, the reference's initial weights carried across)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.core import losses as JL
from neuroimagedisttraining_tpu.core.trainer import ClientState
from neuroimagedisttraining_tpu.data import federate as JFED
from neuroimagedisttraining_tpu.data import partition as JPART
from neuroimagedisttraining_tpu.data import synthetic as JSYN
from neuroimagedisttraining_tpu_torch.config import OptimConfig
from neuroimagedisttraining_tpu_torch.core import losses as PL
from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
from neuroimagedisttraining_tpu_torch.data import federate as PFED
from neuroimagedisttraining_tpu_torch.data import partition as PPART
from neuroimagedisttraining_tpu_torch.data import synthetic as PSYN
from neuroimagedisttraining_tpu_torch.models import create_model
from neuroimagedisttraining_tpu_torch.weights import (
    params_from_flax, params_to_flax,
)

from torch_port_support import (
    dropout_masks, fixed_dropout, jax_alexnet, torch_threads,
)

# the smallest volume whose three stride-3 pools leave more than one
# position (1x2x1): fc1 then sees 256 features in a non-trivial order
SHAPE = (69, 145, 69)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def reference():
    return jax_alexnet(SHAPE, seed=0)


def _port_trainer(masks=None):
    model = create_model("3dcnn", SHAPE)
    return LocalTrainer(model, OptimConfig(), CPU,
                        torch.Generator().manual_seed(0), dropout_masks=masks)


def _batch(seed=0, n=2):
    rng = np.random.default_rng(seed)
    cohort = JSYN.generate_synthetic_abcd(num_subjects=n, shape=SHAPE,
                                          num_sites=1, seed=seed)
    return cohort["X"], rng.integers(0, 2, n).astype(np.int32)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_synthetic_cohort_bit_equal():
    kw = dict(num_subjects=14, shape=(8, 9, 7), num_sites=3, seed=5)
    ref, port = JSYN.generate_synthetic_abcd(**kw), \
        PSYN.generate_synthetic_abcd(**kw)
    for k in ("X", "y", "site"):
        assert port[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(port[k], ref[k])


def test_site_partition_and_federation_equal():
    cohort = JSYN.generate_synthetic_abcd(num_subjects=40, shape=(6, 7, 6),
                                          num_sites=4, seed=2)
    rtr, rte, rs = JPART.site_partition(cohort["site"], seed=42)
    ptr, pte, ps = PPART.site_partition(cohort["site"], seed=42)
    np.testing.assert_array_equal(ps, rs)
    for c in rtr:
        np.testing.assert_array_equal(ptr[c], rtr[c])
        np.testing.assert_array_equal(pte[c], rte[c])
    ref, _ = JFED.federate_cohort(cohort, partition_method="site")
    port, info = PFED.federate_cohort(cohort, CPU)
    for k in ("X_train", "y_train", "X_test", "y_test"):
        np.testing.assert_array_equal(getattr(port, k).numpy(),
                                      np.asarray(getattr(ref, k)))
    np.testing.assert_array_equal(port.n_train, np.asarray(ref.n_train))
    np.testing.assert_array_equal(port.n_test, np.asarray(ref.n_test))
    assert port.X_train.dtype == torch.uint8
    assert info["train_counts"] == [int(v) for v in np.asarray(ref.n_train)]


# ---------------------------------------------------------------------------
# weights bridge + model
# ---------------------------------------------------------------------------

def test_weights_round_trip(reference):
    """flax -> port -> flax returns the identical trees, and the port's
    names and shapes are exactly the module's parameters and buffers."""
    _, jp, jb = reference
    params, bstats = params_from_flax(jp, jb)
    model = create_model("3dcnn", SHAPE)
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert {k: tuple(v.shape) for k, v in bstats.items()} == \
        {k: tuple(v.shape) for k, v in model.named_buffers()}
    back_p, back_b = params_to_flax(params, bstats, jp, jb)
    for a, b in zip(jax.tree.leaves(back_p) + jax.tree.leaves(back_b),
                    jax.tree.leaves(jp) + jax.tree.leaves(jb)):
        np.testing.assert_array_equal(a, b)


def test_port_init_matches_flax_init_statistics():
    """The port's own init follows flax's: lecun-normal kernels (std
    sqrt(1/fan_in), truncated at 2 std), zero biases, BN scale 1, running
    var 1."""
    model = create_model("3dcnn", SHAPE)
    model.reset_parameters(torch.Generator().manual_seed(0))
    p = {k: v.detach() for k, v in model.state_dict().items()}
    w = p["f2.conv.weight"]
    fan_in = w[0].numel()
    assert float(w.std()) == pytest.approx((1 / fan_in) ** 0.5, rel=0.02)
    assert float(w.abs().max()) <= 2 * (1 / fan_in) ** 0.5 / 0.8796 + 1e-6
    assert float(p["fc1.bias"].abs().max()) == 0.0
    assert float(p["f0.bn.weight"].min()) == 1.0
    assert float(p["f0.bn.running_var"].min()) == 1.0


def test_eval_forward_matches(reference):
    """Eval-mode logits (BN on running stats, no dropout) on raw uint8
    volumes; fp32 convolutions summed in other orders: rtol 1e-4."""
    jtrainer, jp, jb = reference
    X, _ = _batch(1)
    ref = np.asarray(jtrainer._apply(jp, jb, jtrainer._prep(jnp.asarray(X)),
                                     train=False)[0])
    params, bstats = params_from_flax(jp, jb)
    port = _port_trainer().apply(params, bstats,
                                 LocalTrainer._prep(torch.from_numpy(X)),
                                 train=False)
    np.testing.assert_allclose(port.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("fast_stem", [False, True])
def test_loss_and_grad_matches(reference, monkeypatch, fast_stem):
    """One training-mode batch with the same dropout keep-masks: loss,
    every gradient leaf and the new BatchNorm running stats. fp32 sums in
    other orders through five conv layers: loss rtol 1e-5; each gradient
    leaf within 1e-3 of its largest entry, or within 1e-5 of the model's
    largest gradient (a conv bias feeding BatchNorm has an exact gradient
    of 0, so both sides hold rounding noise); running stats rtol 5e-4
    (flax's E[x^2] - E[x]^2 loses digits on the stem's raw-intensity
    activations, whose mean is large against their spread)."""
    monkeypatch.setenv("NIDT_FAST_STEM", "1" if fast_stem else "0")
    jtrainer, jp, jb = reference
    X, y = _batch(2)
    jmasks, pmasks = dropout_masks(2, 256, seed=3)
    cs = ClientState(params=jp, batch_stats=jb, opt_state=None,
                     rng=jax.random.key(1))
    with fixed_dropout(jmasks):
        loss, grads, new_b, _ = jax.jit(jtrainer.loss_and_grad)(
            cs, jnp.asarray(X), jnp.asarray(y))
    params, bstats = params_from_flax(jp, jb)
    ref_g, ref_b = params_from_flax(jax.tree.map(np.asarray, grads),
                                    jax.tree.map(np.asarray, new_b))
    ptrainer = _port_trainer(pmasks)
    assert ptrainer.model.f0.fast_stem is fast_stem
    ploss, pgrads, pbstats = ptrainer.loss_and_grad(
        params, bstats, torch.from_numpy(X), torch.from_numpy(y))
    assert float(ploss) == pytest.approx(float(loss), rel=1e-5)
    gmax = max(float(g.abs().max()) for g in ref_g.values())
    for k, g in ref_g.items():
        atol = max(1e-3 * float(g.abs().max()), 1e-5 * gmax)
        np.testing.assert_allclose(pgrads[k].numpy(), g.numpy(), rtol=0,
                                   atol=atol, err_msg=k)
    for k, v in ref_b.items():
        np.testing.assert_allclose(pbstats[k].numpy(), v.numpy(), rtol=5e-4,
                                   atol=1e-5, err_msg=k)
    # the inputs are left untouched
    for k, v in params_from_flax(jp, jb)[1].items():
        np.testing.assert_array_equal(bstats[k].numpy(), v.numpy())


# ---------------------------------------------------------------------------
# losses and metrics
# ---------------------------------------------------------------------------

def test_losses_and_auc_match():
    rng = np.random.default_rng(9)
    z = (rng.standard_normal(37) * 3).astype(np.float32)
    y = rng.integers(0, 2, 37).astype(np.int32)
    w = (rng.random(37) < 0.7).astype(np.float32)
    z[5] = z[6]  # a tie for the AUC's half credit
    for weights in (None, w):
        ref = float(JL.bce_with_logits(jnp.asarray(z), jnp.asarray(y),
                                       None if weights is None
                                       else jnp.asarray(weights)))
        port = float(PL.bce_with_logits(torch.from_numpy(z),
                                        torch.from_numpy(y),
                                        None if weights is None
                                        else torch.from_numpy(weights)))
        assert port == pytest.approx(ref, rel=1e-6)
    np.testing.assert_array_equal(
        PL.predictions(torch.from_numpy(z)).numpy(),
        np.asarray(JL.predictions(jnp.asarray(z), 1)))
    ref = float(JL.binary_auc(jnp.asarray(z), jnp.asarray(y),
                              jnp.asarray(w)))
    port = float(PL.binary_auc(torch.from_numpy(z), torch.from_numpy(y),
                               torch.from_numpy(w)))
    assert port == pytest.approx(ref, rel=1e-6)
    assert float(PL.binary_auc(torch.zeros(3), torch.ones(3))) == 0.5
