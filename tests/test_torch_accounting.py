"""The reference's accounting and the slice-1 gaps, held on the CPU against
the reference package: the FLOPs and communication counters
(``ops/flops.py``), label-balanced IterSNIP draws, and local training with
batches drawn with replacement."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.core.trainer import ClientState
from neuroimagedisttraining_tpu.data.synthetic import generate_synthetic_abcd
from neuroimagedisttraining_tpu.models import create_model as jmodel
from neuroimagedisttraining_tpu.ops import flops as JF
from neuroimagedisttraining_tpu.ops import snip as JSNIP
from neuroimagedisttraining_tpu_torch.config import OptimConfig
from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
from neuroimagedisttraining_tpu_torch.models import create_model
from neuroimagedisttraining_tpu_torch.models.neuro3d import Conv3d, Linear
from neuroimagedisttraining_tpu_torch.ops import flops as PF
from neuroimagedisttraining_tpu_torch.ops import snip as PSNIP
from neuroimagedisttraining_tpu_torch.weights import (
    masks_from_flax, params_from_flax,
)

from torch_port_support import (
    LOSS_RTOL, TRAJECTORY, assert_state_close, dropout_masks, fixed_dropout,
    jax_alexnet, torch_threads,
)

SHAPE = (69, 69, 69)
FLAGSHIP = (121, 145, 121)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads(2):
        yield


def _abstract_reference(shape):
    """The reference's AlexNet3D and its variables, as shapes only."""
    model = jmodel("3dcnn", num_classes=1, remat=False)
    x = jax.ShapeDtypeStruct((1,) + tuple(shape) + (1,), jnp.float32)
    v = jax.eval_shape(lambda x: model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, x,
        train=False), x)
    return model, v, x


def _random_masks(params, seed):
    """Flax-layout 0/1 masks, a different kept fraction per kernel; ones on
    the leaves that are not masked."""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        if path[-1].key == "kernel":
            return (rng.random(leaf.shape) < rng.uniform(0.1, 0.9)
                    ).astype(np.float32)
        return np.ones(leaf.shape, np.float32)

    return jax.tree_util.tree_map_with_path(one, params)


def _port_name(flax_name: str) -> str:
    return flax_name.replace("/", ".").replace("kernel", "weight")


@pytest.mark.parametrize("shape", [SHAPE, FLAGSHIP], ids=["69^3", "flagship"])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_training_flops_equal_reference(shape, masked):
    """Training FLOPs per sample equal the reference's counter exactly, at
    69^3 and at the flagship volume, dense and under a mask's densities
    (which equal the reference's ``densities_from_masks`` too)."""
    model, v, x = _abstract_reference(shape)
    jdens = pdens = None
    if masked:
        jm = _random_masks(v["params"], seed=len(shape) + shape[0])
        jdens = JF.densities_from_masks(jm)
        pdens = PF.densities_from_masks(masks_from_flax(jm))
        assert pdens == {_port_name(k): d for k, d in jdens.items()}
    ref = JF.count_training_flops_per_sample(
        model, v["params"], x, mask_density=jdens,
        batch_stats=v["batch_stats"])
    got = PF.count_training_flops_per_sample(create_model("3dcnn", shape),
                                             shape, pdens)
    assert got == ref
    assert got == 3 * PF.count_inference_flops(create_model("3dcnn", shape),
                                               shape, pdens)


def test_communication_params_equal_reference():
    """Nonzero entries of an update with pruned entries, as the reference
    counts them."""
    _, v, _ = _abstract_reference(SHAPE)
    rng = np.random.default_rng(4)
    upd = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape)
                   * (rng.random(s.shape) < 0.6)).astype(np.float32),
        {"params": v["params"]})["params"]
    got = PF.count_communication_params(params_from_flax(upd, {})[0])
    assert got == JF.count_communication_params(upd)
    assert 0 < got < sum(x.size for x in jax.tree.leaves(upd))


def test_flops_refuse_an_unseen_conv():
    """A conv kernel whose module never runs in the forward would be
    undercounted by its whole spatial extent: the counter raises."""
    class Skips(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = Conv3d(1, 2, 3)
            self.fc = Linear(8, 1)

        def forward(self, x, train=False):
            return self.fc(x.reshape(x.shape[0], -1)[:, :8])

    with pytest.raises(ValueError, match="conv"):
        PF.count_inference_flops(Skips(), (2, 2, 2))


def test_stratified_draws_balance_the_labels():
    """Label-balanced IterSNIP draws: every index is a valid row, and over
    12,000 draws from 9 rows of one label and 3 of the other (4 padded rows
    holding the minority label) each label's share is within 3 sigma of
    1/2."""
    y = torch.tensor([0] * 9 + [1] * 3 + [1] * 4, dtype=torch.int32)
    gen = torch.Generator().manual_seed(5)
    idx = PSNIP.stratified_batch_indices(gen, y, 1200, 10, n_valid=12)
    assert idx.shape == (1200, 10)
    assert int(idx.min()) >= 0 and int(idx.max()) < 12
    share = float((y[idx.reshape(-1)] == 1).to(torch.float64).mean())
    assert abs(share - 0.5) <= 3 * np.sqrt(0.25 / idx.numel())


def test_stratified_iter_snip_scores_match_reference():
    """IterSNIP with ``stratified`` under given batch rows: the scores
    equal the reference's ``iter_snip_scores`` leaf by leaf within 1e-3 of
    the leaf's largest score, or 1e-5 of the largest score overall (the
    gradients' tolerance, test_torch_modules)."""
    jtrainer, jp, jb = jax_alexnet(SHAPE, seed=0)
    cohort = generate_synthetic_abcd(num_subjects=6, shape=SHAPE,
                                     num_sites=1, seed=2)
    X, y = cohort["X"], cohort["y"].astype(np.int32)
    idx = np.asarray([[0, 3], [5, 1]])
    jmasks, pmasks = dropout_masks(2, 128, seed=6)
    cs = ClientState(params=jp, batch_stats=jb, opt_state=None,
                     rng=jax.random.key(3))
    with fixed_dropout(jmasks):
        ref = jax.jit(functools.partial(
            JSNIP.iter_snip_scores, jtrainer, iterations=2, batch_size=2,
            stratified=True))(cs, jnp.asarray(X), jnp.asarray(y), 6,
                              idx_stack=jnp.asarray(idx))
    ref = params_from_flax(jax.tree.map(np.asarray, ref), {})[0]
    params, bstats = params_from_flax(jp, jb)
    trainer = LocalTrainer(create_model("3dcnn", SHAPE), OptimConfig(), CPU,
                           torch.Generator().manual_seed(0),
                           dropout_masks=pmasks)
    got = PSNIP.iter_snip_scores(trainer, params, bstats, torch.from_numpy(X),
                                 torch.from_numpy(y), 6, 2, 2,
                                 stratified=True,
                                 idx_stack=torch.from_numpy(idx))
    smax = max(float(s.abs().max()) for s in ref.values())
    for k, s in ref.items():
        atol = max(1e-3 * float(s.abs().max()), 1e-5 * smax)
        np.testing.assert_allclose(got[k].numpy(), s.numpy(), rtol=0,
                                   atol=atol, err_msg=k)


def test_replacement_local_train_matches_reference():
    """``batch_order="replacement"``: two epochs of 3 steps on 5 valid rows
    of 8 (the reference also scans one masked no-op step an epoch), under
    the rows the reference draws, unweighted loss: the mean loss rtol 1e-4
    and the state at ``TRAJECTORY`` (six SGD steps)."""
    optim = dict(batch_order="replacement", fused_update=True)
    jtrainer, jp, jb = jax_alexnet(SHAPE, seed=0, **optim)
    cohort = generate_synthetic_abcd(num_subjects=8, shape=SHAPE,
                                     num_sites=1, seed=7)
    X, y = cohort["X"], cohort["y"].astype(np.int32)
    n, B, E, nmax = 5, 2, 2, 8
    lr = jnp.float32(0.05)
    key = jax.random.key(11)
    # the rows of each active step, from the reference's own key stream
    spe, my_steps = -(-nmax // B), -(-n // B)
    rng, rows = key, []
    for t in range(E * spe):
        rng, brng, _ = jax.random.split(rng, 3)
        if t % spe < my_steps:
            rows.append(np.asarray(jax.random.randint(brng, (B,), 0, n)))
    jmasks, pmasks = dropout_masks(B, 128, seed=8)
    cs = ClientState(params=jp, batch_stats=jb, opt_state=jtrainer.opt.init(jp),
                     rng=key)
    with fixed_dropout(jmasks):
        ref_cs, ref_loss = jax.jit(functools.partial(
            jtrainer.local_train, epochs=E, batch_size=B, max_samples=nmax))(
            cs, jnp.asarray(X), jnp.asarray(y), n, lr)
    params, bstats = params_from_flax(jp, jb)
    trainer = LocalTrainer(create_model("3dcnn", SHAPE), OptimConfig(**optim),
                           CPU, torch.Generator().manual_seed(0),
                           dropout_masks=pmasks)
    p, b, loss = trainer.local_train(
        params, bstats, torch.from_numpy(X), torch.from_numpy(y), n,
        torch.tensor(0.05), E, B, nmax,
        batch_idx=torch.from_numpy(np.stack(rows)))
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_RTOL)
    assert_state_close(p, b, jax.tree.map(np.asarray, ref_cs.params),
                       jax.tree.map(np.asarray, ref_cs.batch_stats), params,
                       **TRAJECTORY)
