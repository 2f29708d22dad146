"""The port's precision and memory contract held on the CPU against the
reference package: ``validate_precision`` and the CLI's conflicts, the bf16
stem weight gradient's plain version, a ``bf16_mixed`` FedAvg round against
the reference's (float32 master weights), the fixed loss scale, the remat
policies, the tie-splitting max pool (``NIDT_FAST_POOL``) and the
multi-class loss and predictions."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.config import OptimConfig as JOptim
from neuroimagedisttraining_tpu.core import losses as JL
from neuroimagedisttraining_tpu.core.optim import (
    validate_precision as jvalidate,
)
from neuroimagedisttraining_tpu.core.trainer import (
    ClientState, LocalTrainer as JTrainer,
)
from neuroimagedisttraining_tpu.data.partition import site_partition
from neuroimagedisttraining_tpu.data.synthetic import generate_synthetic_abcd
from neuroimagedisttraining_tpu.models import create_model as jcreate
from neuroimagedisttraining_tpu.ops import stemconv as JSC
from neuroimagedisttraining_tpu.ops.pooling import (
    max_pool_3d_nonoverlap as jpool,
)
from neuroimagedisttraining_tpu_torch.__main__ import main
from neuroimagedisttraining_tpu_torch.config import OptimConfig
from neuroimagedisttraining_tpu_torch.core import losses as PL
from neuroimagedisttraining_tpu_torch.core.optim import (
    REMAT_AUTO_SAMPLES, compute_dtype, resolve_remat, validate_precision,
)
from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
from neuroimagedisttraining_tpu_torch.models import create_model
from neuroimagedisttraining_tpu_torch.models.neuro3d import BatchNorm3d
from neuroimagedisttraining_tpu_torch.ops.pooling import (
    max_pool_3d_nonoverlap,
)
from neuroimagedisttraining_tpu_torch.ops.stemconv import stem_dw_plain
from neuroimagedisttraining_tpu_torch.weights import params_from_flax

from torch_port_support import (
    fixed_dropout, model_dropout_masks, run_engine_pair, torch_threads,
)

CPU = torch.device("cpu")
TINY = (12, 14, 12)


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads(2):
        yield


def _bitwise(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# the contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(precision="fp16"), "unknown precision"),
    (dict(loss_scale=128.0), "bf16_mixed"),
    (dict(precision="bf16_mixed", loss_scale=0.0), "positive finite"),
    (dict(precision="bf16_mixed", loss_scale=float("inf")),
     "positive finite"),
    (dict(client_optimizer="adam", fused_update=True), "fused"),
])
def test_validate_precision_refuses_what_the_reference_refuses(kw, match):
    """Each bad combination raises in both packages with the same reason;
    the port's trainer refuses it where it is built."""
    with pytest.raises(ValueError, match=match):
        jvalidate(JOptim(**kw))
    with pytest.raises(ValueError, match=match):
        validate_precision(OptimConfig(**kw))
    if kw.get("precision") != "fp16":
        with pytest.raises(ValueError, match=match):
            LocalTrainer(create_model("3dcnn_tiny", TINY), OptimConfig(**kw),
                         CPU, torch.Generator())


def test_compute_dtype_and_good_configs():
    validate_precision(OptimConfig(precision="bf16_mixed", loss_scale=1024.0))
    validate_precision(OptimConfig())
    assert compute_dtype("bf16_mixed") == torch.bfloat16
    assert compute_dtype("fp32") == torch.float32


@pytest.mark.parametrize("argv,match", [
    (["--loss_scale", "2"], "needs precision=bf16_mixed"),
    (["--fused_update", "--client_optimizer", "adam"], "fused"),
    (["--precision", "fp16"], "invalid choice"),
    (["--remat", "half"], "invalid choice"),
])
def test_cli_refuses_conflicts_at_argparse(argv, match, capsys):
    """The CLI refuses what the reference's refuses, before any data or
    model is built."""
    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu", "--dataset", "synthetic", *argv])
    assert e.value.code == 2
    assert match in capsys.readouterr().err


def test_resolve_remat():
    """``none``/``stem``/``all`` as the models take them; ``auto`` arms stem
    remat past the card's measured batch cutoff of the precision."""
    assert resolve_remat("none", "fp32", 16) is False
    assert resolve_remat("stem", "fp32", 16) == "stem"
    assert resolve_remat("all", "bf16_mixed", 16) is True
    for prec, cut in REMAT_AUTO_SAMPLES.items():
        assert cut > 0
        assert resolve_remat("auto", prec, cut) is False
        assert resolve_remat("auto", prec, cut + 1) == "stem"
    with pytest.raises(ValueError):
        resolve_remat("half", "fp32", 16)


def test_cli_runs_bf16_with_loss_scale_and_remat(capsys):
    """The CLI end to end on the CPU under ``bf16_mixed`` with a loss scale
    and stem remat (the tiny model has no remat blocks, so also the
    GroupNorm model): its last line is the result JSON with finite
    losses."""
    for model, shape in (("3dcnn_tiny", TINY), ("3dcnn_gn", (69, 69, 69))):
        argv = ["--device", "cpu", "--dataset", "synthetic",
                "--synthetic_shape", *map(str, shape),
                "--synthetic_num_subjects", "8", "--client_num_in_total",
                "4", "--comm_round", "1", "--batch_size", "2", "--epochs",
                "1", "--fused_update", "--model", model, "--precision",
                "bf16_mixed", "--loss_scale", "1024", "--remat", "stem"]
        assert main(argv) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert all(np.isfinite(h["train_loss"]) for h in out["history"])


# ---------------------------------------------------------------------------
# the bf16 stem weight gradient (its plain version; the kernel is held
# against it on the card by chip_smoke.py)
# ---------------------------------------------------------------------------

def test_bf16_stem_dw_plain_matches_reference():
    """bf16 x (integral voxels) and g: the plain dW (an f32 product of the
    bf16 values, rounded to bf16) against the reference's bf16 kernel
    gradient (XLA's autodiff of the bf16 conv, its CPU path): every entry
    within one bf16 unit in the last place (2^-7 of the entry at most: the
    two round sums that differ in their last f32 bits) and at least 99.9% of
    them bit-equal (measured 99.99%); before the rounding, within 1e-6 of
    the largest entry of the float64 sum (measured 1.6e-7)."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (2, 29, 31, 29, 1)).astype(np.float32)
    w = rng.standard_normal((5, 5, 5, 1, 64)).astype(np.float32)
    g = rng.standard_normal(JSC._conv(jnp.asarray(x), jnp.asarray(w)).shape
                            ).astype(np.float32)
    ref = np.asarray(JSC._dw_reference(jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(g, jnp.bfloat16)))
    assert ref.dtype == jnp.bfloat16
    ref = ref.astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    gt = torch.from_numpy(g).to(torch.bfloat16)
    got = stem_dw_plain(xt, gt)
    assert got.dtype == torch.bfloat16 and got.shape == (5, 5, 5, 1, 64)
    got = got.float().numpy()
    assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref))
    assert np.mean(got == ref) >= 0.999
    f32 = stem_dw_plain(xt, gt, torch.float32).numpy().astype(np.float64)
    x64 = xt.double().numpy()[..., 0]
    g64 = gt.double().numpy()
    od, oh, ow = g.shape[1:4]
    exact = np.stack([np.einsum(
        "bdhw,bdhwc->c",
        x64[:, kd:kd + 2 * od - 1:2, kh:kh + 2 * oh - 1:2,
            kw:kw + 2 * ow - 1:2], g64)
        for kd in range(5) for kh in range(5) for kw in range(5)])
    assert (np.abs(f32.reshape(125, 64) - exact).max()
            <= 1e-6 * np.abs(exact).max())


# ---------------------------------------------------------------------------
# bf16_mixed end to end against the reference; loss scale; masters
# ---------------------------------------------------------------------------

def _tiny_federation():
    c = generate_synthetic_abcd(num_subjects=96, shape=TINY, num_sites=4,
                                seed=0)
    train_map, test_map, _ = site_partition(c["site"], seed=42)
    return c["X"], c["y"], train_map, test_map


OPTIM = dict(lr=1e-3, batch_size=8, epochs=1, precision="bf16_mixed")
FED = dict(client_num_in_total=4, comm_round=2, frequency_of_the_test=1)


@pytest.fixture(scope="module")
def bf16_runs(tmp_path_factory):
    with torch_threads(2):
        return run_engine_pair("fedavg", _tiny_federation(), OPTIM, FED,
                               tmp_path_factory.mktemp("bf16"), shape=TINY,
                               model="3dcnn_tiny")


def test_bf16_round_matches_reference(bf16_runs):
    """Two bf16_mixed FedAvg rounds (4 clients, the final fine-tune) of the
    tiny model, the port's against the reference's on the same inputs, at
    the reference's own bf16-against-fp32 pin: each round's loss within
    2e-3 absolute, the global weights within 5e-3 absolute (bf16 rounds at
    other places in the two frameworks)."""
    jres, pres, _, _, _ = bf16_runs
    for hj, hp in zip(jres["history"], pres["history"]):
        assert abs(hp["train_loss"] - hj["train_loss"]) < 2e-3
    ref_p, ref_b = params_from_flax(jax.tree.map(np.asarray, jres["params"]),
                                    jax.tree.map(np.asarray,
                                                 jres["batch_stats"]))
    for k, v in ref_p.items():
        np.testing.assert_allclose(pres["params"][k].numpy(), v.numpy(),
                                   rtol=0, atol=5e-3, err_msg=k)


def test_bf16_master_state_stays_float32(bf16_runs):
    """Every master leaf, stat and personal state is float32 after a
    bf16_mixed run (bf16 exists only inside a step)."""
    _, pres, _, peng, _ = bf16_runs
    assert peng.trainer.model.fc2.dtype == torch.bfloat16
    for st in (pres["params"], pres["batch_stats"],
               *pres["personal"]["params"], *pres["personal"]["batch_stats"]):
        for k, v in st.items():
            assert v.dtype == torch.float32, k


def _port_fedavg(loss_scale: float):
    from neuroimagedisttraining_tpu_torch.config import (
        DataConfig, ExperimentConfig, FedConfig,
    )
    from neuroimagedisttraining_tpu_torch.data.federate import (
        build_federated_data,
    )
    from neuroimagedisttraining_tpu_torch.engines import create_engine

    X, y, tr, te = _tiny_federation()
    cfg = ExperimentConfig(
        model="3dcnn_tiny", algorithm="fedavg",
        data=DataConfig(dataset="synthetic", synthetic_shape=TINY),
        optim=OptimConfig(**dict(OPTIM, loss_scale=loss_scale)),
        fed=FedConfig(**FED))
    trainer = LocalTrainer(create_model("3dcnn_tiny", TINY,
                                        dtype=torch.bfloat16),
                           cfg.optim, CPU, torch.Generator().manual_seed(0))
    eng = create_engine("fedavg", cfg,
                        build_federated_data(X, y, tr, te, CPU), trainer)
    return eng.train()


def test_loss_scale_1024_is_bit_equal_to_scale_1():
    """A power-of-two loss scale multiplies and divides float32 values
    exactly and bf16 keeps float32's exponent range: two bf16_mixed FedAvg
    rounds at scale 1024 equal those at scale 1 bit for bit (weights,
    stats, losses), as the reference's pin."""
    a, b = _port_fedavg(1.0), _port_fedavg(1024.0)
    _bitwise(a["params"], b["params"])
    _bitwise(a["batch_stats"], b["batch_stats"])
    assert a["history"] == b["history"]


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,precision", [
    ("3dcnn", "fp32"), ("3dcnn", "bf16_mixed"), ("3dcnn_gn", "fp32")])
def test_remat_is_bit_equal_and_moves_stats_once(name, precision,
                                                  monkeypatch):
    """Two local SGD steps at 69^3 under remat ``stem`` and ``all`` equal the
    run without remat bit for bit (weights, BatchNorm running stats, loss),
    with the fast stem on; each BatchNorm's running stats move once a step
    (the checkpointed blocks are pure: the recompute moves none)."""
    monkeypatch.setenv("NIDT_FAST_STEM", "1")
    shape = (69, 69, 69)
    X = torch.from_numpy(generate_synthetic_abcd(
        num_subjects=4, shape=shape, num_sites=1, seed=5)["X"])
    y = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    _, masks = model_dropout_masks(name, shape, 2, seed=6)
    perms = torch.tensor([[2, 0, 3, 1]])
    updates = []
    orig = BatchNorm3d.update

    def counted(self, mean, var):
        updates.append(self)
        return orig(self, mean, var)

    monkeypatch.setattr(BatchNorm3d, "update", counted)
    out = {}
    for remat in (False, "stem", True):
        model = create_model(name, shape, dtype=compute_dtype(precision),
                             remat=remat)
        model.reset_parameters(torch.Generator().manual_seed(0))
        params = {k: v.detach().clone() for k, v in model.named_parameters()}
        bstats = {k: v.clone() for k, v in model.named_buffers()}
        tr = LocalTrainer(model, OptimConfig(precision=precision), CPU,
                          torch.Generator().manual_seed(0),
                          dropout_masks=masks)
        updates.clear()
        p, b, loss = tr.local_train(params, bstats, X, y, 4, 0.01, 1, 2, 4,
                                    perms=perms)
        n_bn = sum(isinstance(m, BatchNorm3d) for m in model.modules())
        assert len(updates) == 2 * n_bn  # once a step
        out[remat] = (p, b, loss)
        if b:
            assert not torch.equal(b["f0.bn.running_mean"],
                                   bstats["f0.bn.running_mean"])
    for remat in ("stem", True):
        _bitwise(out[remat][0], out[False][0])
        _bitwise(out[remat][1], out[False][1])
        assert torch.equal(out[remat][2], out[False][2])


# ---------------------------------------------------------------------------
# NIDT_FAST_POOL
# ---------------------------------------------------------------------------

def _grads(pool, x, g):
    x = x.clone().requires_grad_(True)
    (pool(x) * g).sum().backward()
    return x.grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fast_pool_matches_reference(dtype):
    """``max_pool_3d_nonoverlap``: the forward bit-equal to the reference's
    and to ``F.max_pool3d``; the gradient against the reference's op on
    tie-free normal inputs (rtol 1e-6; bf16 bit-equal) and on tied ones
    (all-zero windows, and integers 0-3 where positive maxima tie), and
    there it conserves each window's gradient: sum(dx) == sum(g)."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rng = np.random.default_rng(7)
    cases = [rng.standard_normal((2, 3, 7, 9, 7)),
             np.zeros((1, 2, 6, 6, 6)),
             rng.integers(0, 4, (2, 3, 7, 8, 6)).astype(np.float64)]
    for xn in cases:
        x = torch.from_numpy(xn).to(tdt)
        gshape = [s // 3 if i >= 2 else s for i, s in enumerate(x.shape)]
        g = torch.from_numpy(rng.standard_normal(gshape)).to(tdt)
        y = max_pool_3d_nonoverlap(x, 3)
        assert torch.equal(y, torch.nn.functional.max_pool3d(x, 3, 3))
        xj = jnp.asarray(x.float().numpy()).astype(jdt).transpose(
            0, 2, 3, 4, 1)
        gj = jnp.asarray(g.float().numpy()).astype(jdt).transpose(
            0, 2, 3, 4, 1)
        np.testing.assert_array_equal(
            y.float().numpy(), np.asarray(jpool(xj, 3), np.float32
                                          ).transpose(0, 4, 1, 2, 3))
        want = np.asarray(jax.grad(lambda v: jnp.sum(
            (jpool(v, 3) * gj).astype(jnp.float32)))(xj), np.float32
        ).transpose(0, 4, 1, 2, 3)
        got = _grads(lambda v: max_pool_3d_nonoverlap(v, 3), x, g)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=1e-6 if dtype == "float32" else 0,
                                   atol=1e-7 if dtype == "float32" else 0)
        assert float(got.double().sum()) == pytest.approx(
            float(g.double().sum()), rel=1e-5 if dtype == "float32"
            else 1e-2)


def test_fast_pool_model_path_matches_reference(monkeypatch):
    """``NIDT_FAST_POOL=1`` in a model: the tiny model's training batch (its
    2^3 pools take the tie-splitting op in both packages) against the
    reference's under the same switch, at the zoo test's tolerances; and
    the switch leaves a padded pool (ResNet3D's) to ``F.max_pool3d``."""
    monkeypatch.setenv("NIDT_FAST_POOL", "1")
    jt = JTrainer(jcreate("3dcnn_tiny", num_classes=1), JOptim(),
                  num_classes=1)
    cs = jt.init_client_state(jax.random.key(0), jnp.zeros((1,) + TINY))
    jp = jax.tree.map(np.asarray, cs.params)
    jb = jax.tree.map(np.asarray, cs.batch_stats)
    X = generate_synthetic_abcd(num_subjects=2, shape=TINY, num_sites=1,
                                seed=2)["X"]
    y = np.array([0, 1], np.int32)
    jmasks, pmasks = model_dropout_masks("3dcnn_tiny", TINY, 2, seed=3)
    with fixed_dropout(jmasks):
        loss, grads, new_b, _ = jt.loss_and_grad(
            ClientState(params=jp, batch_stats=jb, opt_state=None,
                        rng=jax.random.key(1)),
            jnp.asarray(X), jnp.asarray(y))
    from neuroimagedisttraining_tpu_torch.models import neuro3d

    calls = []
    fast = neuro3d.max_pool_3d_nonoverlap
    monkeypatch.setattr(neuro3d, "max_pool_3d_nonoverlap",
                        lambda x, k: calls.append(k) or fast(x, k))
    params, bstats = params_from_flax(jp, jb)
    pt = LocalTrainer(create_model("3dcnn_tiny", TINY), OptimConfig(), CPU,
                      torch.Generator(), dropout_masks=pmasks)
    ploss, pgrads, _ = pt.loss_and_grad(params, bstats, torch.from_numpy(X),
                                        torch.from_numpy(y))
    assert calls == [2, 2]
    assert float(ploss) == pytest.approx(float(loss), rel=1e-4)
    ref_g, _ = params_from_flax(jax.tree.map(np.asarray, grads), {})
    gmax = max(float(g.abs().max()) for g in ref_g.values())
    for k, g in ref_g.items():
        atol = max(1e-3 * float(g.abs().max()), 1e-5 * gmax)
        np.testing.assert_allclose(pgrads[k].numpy(), g.numpy(), rtol=0,
                                   atol=atol, err_msg=k)
    calls.clear()
    neuro3d.max_pool(torch.zeros(1, 1, 6, 6, 6), 3, 2, pad=1)
    assert not calls


# ---------------------------------------------------------------------------
# several classes
# ---------------------------------------------------------------------------

def test_softmax_ce_and_argmax_match_reference():
    """Integer-label cross-entropy (unweighted and weighted, rtol 1e-6) and
    argmax predictions (ties to the first maximum, bit-equal) against the
    reference's; ``make_loss`` picks BCE for one logit."""
    rng = np.random.default_rng(9)
    z = (rng.standard_normal((37, 5)) * 3).astype(np.float32)
    z[3, 1] = z[3, 4] = z[3].max() + 1  # a tie
    y = rng.integers(0, 5, 37).astype(np.int32)
    w = (rng.random(37) < 0.7).astype(np.float32)
    for weights in (None, w):
        ref = float(JL.softmax_ce(jnp.asarray(z), jnp.asarray(y),
                                  None if weights is None
                                  else jnp.asarray(weights)))
        got = float(PL.softmax_ce(torch.from_numpy(z), torch.from_numpy(y),
                                  None if weights is None
                                  else torch.from_numpy(weights)))
        assert got == pytest.approx(ref, rel=1e-6)
    np.testing.assert_array_equal(
        PL.predictions(torch.from_numpy(z), 5).numpy(),
        np.asarray(JL.predictions(jnp.asarray(z), 5)))
    assert PL.make_loss(1) is PL.bce_with_logits
    assert PL.make_loss(5) is PL.softmax_ce


def test_multiclass_trainer_matches_reference():
    """``num_classes=3`` through the trainer (the tiny model, three logits,
    CE): a training batch's loss and gradients and the evaluation's
    correct count, loss and scores (the last class's log-probability)
    against the reference's trainer, at the zoo test's tolerances."""
    jt = JTrainer(jcreate("3dcnn_tiny", num_classes=3), JOptim(),
                  num_classes=3)
    cs = jt.init_client_state(jax.random.key(0), jnp.zeros((1,) + TINY))
    jp = jax.tree.map(np.asarray, cs.params)
    jb = jax.tree.map(np.asarray, cs.batch_stats)
    X = generate_synthetic_abcd(num_subjects=5, shape=TINY, num_sites=1,
                                seed=2)["X"]
    y = np.array([0, 1, 2, 2, 1], np.int32)
    jmasks, pmasks = model_dropout_masks("3dcnn_tiny", TINY, 5, seed=3)
    with fixed_dropout(jmasks):
        loss, grads, _, _ = jt.loss_and_grad(
            ClientState(params=jp, batch_stats=jb, opt_state=None,
                        rng=jax.random.key(1)),
            jnp.asarray(X), jnp.asarray(y))
    valid = np.array([1, 1, 1, 1, 0], bool)
    jm = jt.evaluate(jp, jb, jnp.asarray(X), jnp.asarray(y),
                     jnp.asarray(valid), batch_size=2)
    params, bstats = params_from_flax(jp, jb)
    pt = LocalTrainer(create_model("3dcnn_tiny", TINY, num_classes=3),
                      OptimConfig(), CPU, torch.Generator(),
                      dropout_masks=pmasks, num_classes=3)
    ploss, pgrads, _ = pt.loss_and_grad(params, bstats, torch.from_numpy(X),
                                        torch.from_numpy(y))
    assert float(ploss) == pytest.approx(float(loss), rel=1e-4)
    ref_g, _ = params_from_flax(jax.tree.map(np.asarray, grads), {})
    gmax = max(float(g.abs().max()) for g in ref_g.values())
    for k, g in ref_g.items():
        atol = max(1e-3 * float(g.abs().max()), 1e-5 * gmax)
        np.testing.assert_allclose(pgrads[k].numpy(), g.numpy(), rtol=0,
                                   atol=atol, err_msg=k)
    pm = pt.evaluate(params, bstats, torch.from_numpy(X),
                     torch.from_numpy(y), torch.from_numpy(valid),
                     batch_size=2)
    assert float(pm["test_correct"]) == float(jm["test_correct"])
    assert float(pm["test_total"]) == float(jm["test_total"])
    assert float(pm["test_loss"]) == pytest.approx(float(jm["test_loss"]),
                                                   rel=1e-5)
    np.testing.assert_allclose(pm["scores"].numpy(), np.asarray(jm["scores"]),
                               rtol=1e-5, atol=1e-6)


def test_precision_fields_in_configs():
    """The port's configs carry the reference's precision fields and
    defaults."""
    from neuroimagedisttraining_tpu.config import (
        ExperimentConfig as JExp,
    )
    from neuroimagedisttraining_tpu_torch.config import ExperimentConfig

    for f in ("precision", "loss_scale"):
        assert getattr(OptimConfig(), f) == getattr(JOptim(), f)
    assert ExperimentConfig().remat == JExp().remat == "auto"
    assert ExperimentConfig().num_classes == JExp().num_classes == 1
    assert dataclasses.replace(OptimConfig(), precision="bf16_mixed")
