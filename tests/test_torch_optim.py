"""The local optimizers against the reference package.

The per-round learning rate at negative rounds: FedAvg's final fine-tune
runs at round -1, where the reference computes ``lr * lr_decay**-1`` (an
integer power with a negative exponent: the reciprocal of the repeated
squaring), not the end-of-training rate.

The Adam client optimizer (``client_optimizer="adam"``): one step and a
run of steps against the reference's optax chain (clip, ``scale_by_adam``,
weight decay, ``-lr``), a whole ``local_train`` against the reference's at
``TRAJECTORY``, its state carried across calls as Sub-FedAvg carries it,
and the refusal of ``--fused_update``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.config import OptimConfig as JOptim
from neuroimagedisttraining_tpu.core import optim as JO
from neuroimagedisttraining_tpu.core.optim import round_lr as jround_lr
from neuroimagedisttraining_tpu.core.trainer import ClientState
from neuroimagedisttraining_tpu.data.synthetic import generate_synthetic_abcd
from neuroimagedisttraining_tpu_torch.__main__ import main
from neuroimagedisttraining_tpu_torch.config import OptimConfig
from neuroimagedisttraining_tpu_torch.core import optim as PO
from neuroimagedisttraining_tpu_torch.core.optim import round_lr
from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
from neuroimagedisttraining_tpu_torch.models import create_model
from neuroimagedisttraining_tpu_torch.weights import params_from_flax

from torch_port_support import (
    LOSS_RTOL, TRAJECTORY, assert_state_close, dropout_masks, fixed_dropout,
    jax_alexnet, torch_threads,
)

CPU = torch.device("cpu")

ROUNDS = [-3, -1, 0, 1, 7, 199]


@pytest.mark.parametrize("lr_decay", [0.998, 0.95])
def test_round_lr_bit_equal_at_negative_rounds(lr_decay):
    """Bit-equal to the reference at every round of ``ROUNDS``."""
    ref = np.asarray([jround_lr(JOptim(lr_decay=lr_decay), r)
                      for r in ROUNDS], dtype=np.float32)
    port = np.asarray([round_lr(OptimConfig(lr_decay=lr_decay), r,
                                torch.device("cpu")).numpy() for r in ROUNDS])
    np.testing.assert_array_equal(port.view(np.int32), ref.view(np.int32))


def test_finetune_lr_is_lr_over_decay():
    """At the defaults round -1 gives float32 0.01002004 (= 0.01 / 0.998),
    above the initial rate."""
    got = round_lr(OptimConfig(), -1, torch.device("cpu"))
    assert got.dtype == torch.float32
    assert got.numpy().view(np.int32) == np.float32(0.01002004).view(np.int32)
    assert float(got) > OptimConfig().lr


def _adam_chain(cfg: dict, steps: int, seed: int, jit: bool = True):
    """``steps`` Adam steps of the reference's optax chain (jitted, or op
    by op) and of the port's plain chain on the same leaves and grads:
    ``(reference leaves, port leaves, port state)``."""
    rng = np.random.default_rng(seed)
    p = {"a": rng.standard_normal((7, 9)).astype(np.float32),
         "b": rng.standard_normal((3,)).astype(np.float32)}
    cfg = dict(client_optimizer="adam", lr=0.05, **cfg)
    jopt = JO.make_local_optimizer(JOptim(**cfg))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = jopt.init(jp)
    update = jax.jit(jopt.update) if jit else jopt.update
    popt = PO.LocalOptimizer(OptimConfig(**cfg))
    names = sorted(p)
    pp = [torch.from_numpy(p[k]).clone() for k in names]
    state = popt.init(pp)
    for step in range(steps):
        g = {k: (rng.standard_normal(v.shape) * (step + 1)).astype(np.float32)
             for k, v in p.items()}
        upd, js = update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                         jnp.float32(0.05))
        jp = jax.tree.map(jnp.add, jp, upd)
        popt.step(pp, [torch.from_numpy(g[k]) for k in names], state,
                  torch.tensor(np.float32(0.05)))
    return [np.asarray(jp[k]) for k in names], [x.numpy() for x in pp], state


@pytest.mark.parametrize("clip", [0.0, 1.0, 1e3])
def test_adam_one_step_bit_close(clip):
    """One step from zero moments, clip off, taken (gnorm above 1) or not:
    bit-equal to the reference's chain run op by op, and within 16 ulp of
    its jitted chain (XLA's fusion rounds Adam's update ``u`` one ulp off
    the op-by-op value, and ``-lr * u`` carries that into the weights)."""
    ref, got, state = _adam_chain(dict(grad_clip=clip, wd=5e-4), 1, 3,
                                  jit=False)
    assert state.count == 1
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    ref, got, _ = _adam_chain(dict(grad_clip=clip, wd=5e-4), 1, 3)
    for a, b in zip(got, ref):
        np.testing.assert_array_max_ulp(a, b, maxulp=16)


@pytest.mark.parametrize("wd", [0.0, 5e-4])
def test_adam_steps_match_optax_chain(wd):
    """Twenty steps with the clip taken in the late ones (the grads grow):
    the bias corrections at every count are the reference's, and the
    leaves stay within rtol 1e-6 / atol 1e-6."""
    ref, got, state = _adam_chain(dict(grad_clip=10.0, wd=wd), 20, 4)
    assert state.count == 20
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_adam_bias_correction_bit_equal():
    """``1 - decay**count`` for counts 1..2000 bit-equal to the reference's
    jitted power for both of Adam's decays."""
    counts = np.arange(1, 2001)
    for decay in (PO.ADAM_B1, PO.ADAM_B2):
        ref = np.asarray(jax.jit(lambda c: 1 - decay ** c)(
            jnp.asarray(counts, jnp.int32)))
        got = np.asarray([PO._bias_correction(decay, int(c))
                          for c in counts], np.float32)
        np.testing.assert_array_equal(got.view(np.int32),
                                      ref.view(np.int32))


SHAPE = (69, 69, 69)


def _cohort():
    c = generate_synthetic_abcd(num_subjects=8, shape=SHAPE, num_sites=1,
                                seed=7)
    return c["X"], c["y"].astype(np.int32)


#: the share of weight entries that Adam moves apart between the two
#: packages in six steps. Adam divides each moment by its root-mean-square,
#: so an entry whose gradient is rounding noise (a conv bias under
#: BatchNorm, a stem weight whose gradient sums to about 0) takes a step of
#: up to lr in the noise's direction: one step from the same weights
#: already differs in 248 of 2.56 M entries by about 2 lr. Measured after
#: six steps: 8.3e-3 of the entries beyond TRAJECTORY's tolerance
ADAM_SHARE = 2e-2


def test_adam_local_train_matches_reference():
    """Two epochs of local Adam (3 steps an epoch on 5 valid rows of 8,
    batch 2, clip 10, weight decay) under the reference's epoch
    permutations, the step count running across the epochs to 6 on both
    sides: the mean loss at ``LOSS_RTOL``; at most ``ADAM_SHARE`` of the
    weight entries beyond ``TRAJECTORY``'s tolerance, and the others at
    ``TRAJECTORY``. The BN stats are not held: they follow the weights
    that moved apart."""
    optim = dict(client_optimizer="adam", lr=1e-3)
    jtrainer, jp, jb = jax_alexnet(SHAPE, seed=0, **optim)
    X, y = _cohort()
    n, B, E, nmax = 5, 2, 2, 8
    key = jax.random.key(11)
    from neuroimagedisttraining_tpu.core.trainer import epoch_perms_for
    perms = np.asarray(epoch_perms_for(key, E, nmax, n))
    jmasks, pmasks = dropout_masks(B, 128, seed=8)
    cs = ClientState(params=jp, batch_stats=jb,
                     opt_state=jtrainer.opt.init(jp), rng=key)
    with fixed_dropout(jmasks):
        ref_cs, ref_loss = jax.jit(functools.partial(
            jtrainer.local_train, epochs=E, batch_size=B, max_samples=nmax))(
            cs, jnp.asarray(X), jnp.asarray(y), n, jnp.float32(1e-3))
    assert int(ref_cs.opt_state[1].count) == 6
    params, bstats = params_from_flax(jp, jb)
    trainer = LocalTrainer(create_model("3dcnn", SHAPE), OptimConfig(**optim),
                           CPU, torch.Generator().manual_seed(0),
                           dropout_masks=pmasks)
    with torch_threads(2):
        p, b, loss = trainer.local_train(
            params, bstats, torch.from_numpy(X), torch.from_numpy(y), n,
            torch.tensor(np.float32(1e-3)), E, B, nmax,
            perms=torch.from_numpy(perms.copy()))
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_RTOL)
    ref_p, _ = params_from_flax(jax.tree.map(np.asarray, ref_cs.params), {})
    moved = max(float((v - params[k]).abs().max()) for k, v in ref_p.items())
    off = {k: (p[k] - v).abs() > TRAJECTORY["atol_moved"] * moved
           for k, v in ref_p.items()}
    share = sum(int(v.sum()) for v in off.values()) / sum(
        v.numel() for v in off.values())
    assert share <= ADAM_SHARE, share
    kept = {k: torch.where(off[k], ref_p[k], v) for k, v in p.items()}
    assert_state_close(kept, None, jax.tree.map(np.asarray, ref_cs.params),
                       None, params, **TRAJECTORY)


def test_adam_state_carries_across_calls():
    """Sub-FedAvg's epoch split: one epoch and then another from
    ``init_momentum``'s shared state equal two epochs in one call bit for
    bit (moments and step count carried, the count ending at 6)."""
    X, y = _cohort()
    n, B, nmax = 5, 2, 8
    _, pmasks = dropout_masks(B, 128, seed=8)
    trainer = LocalTrainer(create_model("3dcnn", SHAPE),
                           OptimConfig(client_optimizer="adam", lr=1e-3),
                           CPU, torch.Generator().manual_seed(0),
                           dropout_masks=pmasks)
    model = create_model("3dcnn", SHAPE)
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    bstats = {k: v.clone() for k, v in model.named_buffers()}
    perms = torch.stack([torch.randperm(nmax), torch.randperm(nmax)])
    Xt, yt, lr = torch.from_numpy(X), torch.from_numpy(y), torch.tensor(1e-3)
    with torch_threads(2):
        p2, b2, _ = trainer.local_train(params, bstats, Xt, yt, n, lr, 2, B,
                                        nmax, perms=perms)
        state = trainer.init_momentum(params)
        assert isinstance(state, PO.AdamState) and state.count == 0
        p1, b1, _ = trainer.local_train(params, bstats, Xt, yt, n, lr, 1, B,
                                        nmax, perms=perms[:1],
                                        momentum=state)
        assert state.count == 3
        p1, b1, _ = trainer.local_train(p1, b1, Xt, yt, n, lr, 1, B, nmax,
                                        perms=perms[1:], momentum=state)
    assert state.count == 6
    for k, v in p2.items():
        assert torch.equal(p1[k], v), k
    assert any(float(m.abs().max()) > 0 for m in state.mu.values())


def test_adam_refuses_fused_update(capsys):
    """Adam has no fused kernel: the optimizer and the CLI refuse
    ``fused_update`` (the reference's error), so an Adam run launches no
    ``fused_sgd``; an unknown optimizer is refused too."""
    with pytest.raises(ValueError, match="no fused kernel"):
        PO.LocalOptimizer(OptimConfig(client_optimizer="adam",
                                      fused_update=True))
    with pytest.raises(ValueError, match="no fused kernel"):
        JO.validate_precision(JOptim(client_optimizer="adam",
                                     fused_update=True))
    with pytest.raises(ValueError, match="unknown client_optimizer"):
        PO.LocalOptimizer(OptimConfig(client_optimizer="lamb"))
    with pytest.raises(SystemExit):
        main(["--client_optimizer", "adam", "--fused_update", "--device",
              "cpu"])
    assert "no fused kernel" in capsys.readouterr().err
