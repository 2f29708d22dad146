"""The port's DARTS family (``models/darts.py``) held on the CPU against the
reference package's flax definitions on the same inputs (numpy draws from a
seed, the reference's weights carried across by ``weights.py``): each
candidate operation's forward and input gradient, the fixed-genotype
network with its auxiliary head and drop-path, the search supernet under
the softmax mixture and GDAS, ``derive_genotype``, both arch gradients,
``DartsSearch`` and ``DartsTrainer``, and at full width the leaf counts and
the maskable leaf order.

Shapes are the reference's own DARTS tests': C=4, 3 cells, 16x16 (the
search net) or 32x32 (the fixed net: its auxiliary head wants 8x8 after
the two reductions), batch 4. Randomness the reference draws from its
``droppath`` / ``gumbel`` streams is fed to both as the same arrays (its
``_drop_path`` / ``_gumbel_hard`` replaced for the test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from neuroimagedisttraining_tpu.core.losses import softmax_ce as jsoftmax_ce
from neuroimagedisttraining_tpu.models import darts as J
from neuroimagedisttraining_tpu_torch.core.losses import softmax_ce
from neuroimagedisttraining_tpu_torch.models import darts as P
from neuroimagedisttraining_tpu_torch.weights import (
    params_from_flax, params_to_flax,
)

from torch_port_support import (
    LOSS_RTOL, TRAJECTORY, assert_state_close, torch_threads,
)

B = 4
CLASSES = 10


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads(2):
        yield


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, rtol, what=""):
    """``got`` within ``rtol`` of ``want`` elementwise or ``rtol`` of its
    largest entry (entries near 0 carry only rounding)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


def _perturb(variables, seed: int):
    """A flax tree with every BatchNorm scale, bias and running stat moved
    off its init (scale 1 +- 0.1, bias and mean 0 +- 0.1, var 1 + U(0,
    0.5)), so the norms' every term is exercised."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        a = np.asarray(a)
        leaf = path[-1].key
        if leaf == "scale":
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if leaf in ("bias", "mean"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if leaf == "var":
            return (a + 0.5 * rng.random(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(move, variables)


# ---------------------------------------------------------------------------
# the candidate operations
# ---------------------------------------------------------------------------

C_OP = 6
#: op cases: (the reference's module or function, the port's, stride)
OPS = {
    "avg_pool_s1": (lambda: J.avg_pool_3x3, lambda: P.avg_pool_3x3, 1),
    "avg_pool_s2": (lambda: J.avg_pool_3x3, lambda: P.avg_pool_3x3, 2),
    "max_pool_s1": (lambda: J.max_pool_3x3, lambda: P.max_pool_3x3, 1),
    "max_pool_s2": (lambda: J.max_pool_3x3, lambda: P.max_pool_3x3, 2),
    "zero_s1": (lambda: J._zero, lambda: P._zero, 1),
    "zero_s2": (lambda: J._zero, lambda: P._zero, 2),
    "bn_search_affine": (lambda: J._BN(True, False),
                         lambda: P._BN(C_OP, True, False), None),
    "bn_search_plain": (lambda: J._BN(False, False),
                        lambda: P._BN(C_OP, False, False), None),
    "bn_tracked": (lambda: J._BN(True, True), lambda: P._BN(C_OP, True, True),
                   None),
    "sep_conv_3x3_s1": (lambda: J.SepConv(C_OP, 3, 1, track=True),
                        lambda: P.SepConv(C_OP, C_OP, 3, 1, track=True), None),
    "sep_conv_5x5_s2": (lambda: J.SepConv(C_OP, 5, 2, affine=False),
                        lambda: P.SepConv(C_OP, C_OP, 5, 2, affine=False),
                        None),
    "dil_conv_3x3_s2": (lambda: J.DilConv(C_OP, 3, 2, track=True),
                        lambda: P.DilConv(C_OP, C_OP, 3, 2, track=True), None),
    "dil_conv_5x5_s1": (lambda: J.DilConv(C_OP, 5, 1),
                        lambda: P.DilConv(C_OP, C_OP, 5, 1), None),
    "factorized_reduce": (lambda: J.FactorizedReduce(C_OP, track=True),
                          lambda: P.FactorizedReduce(C_OP, C_OP, track=True),
                          None),
    "conv_7x1_1x7_s1": (lambda: J.Conv7x1_1x7(C_OP, 1, track=True),
                        lambda: P.Conv7x1_1x7(C_OP, C_OP, 1, track=True),
                        None),
    "conv_7x1_1x7_s2": (lambda: J.Conv7x1_1x7(C_OP, 2),
                        lambda: P.Conv7x1_1x7(C_OP, C_OP, 2), None),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", list(OPS))
def test_op_matches_reference(case, train):
    """Each candidate operation on ``[4, 6, 10, 10]`` Gaussian inputs, in
    training and evaluation mode: its output and the gradient of a random
    projection of it with respect to the input, rtol 1e-5 (and 1e-5 of the
    largest entry). The tracked BatchNorms run on moved running stats in
    evaluation; search mode takes the batch's statistics in both modes."""
    make_j, make_p, stride = OPS[case]
    jop, pop = make_j(), make_p()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 10, 10, C_OP)).astype(np.float32)
    if stride is not None:
        def jfn(a):
            return jop(a, stride)
        params, bstats = {}, {}
        pfn = pop
        pargs = (stride,)
    else:
        v = _perturb(jop.init(jax.random.key(0), x, train=False), 1)
        params, bstats = params_from_flax(v.get("params", {}),
                                          v.get("batch_stats", {}))

        def jfn(a):
            if train and "batch_stats" in v:
                return jop.apply(v, a, train=True,
                                 mutable=["batch_stats"])[0]
            return jop.apply(v, a, train=train)

        def pfn(a):
            return functional_call(pop, (params, {k: t.clone() for k, t in
                                                  bstats.items()}),
                                   (a, train))
        pargs = ()
    want, vjp = jax.vjp(jfn, jnp.asarray(x))
    cot = rng.standard_normal(want.shape).astype(np.float32)
    (want_g,) = vjp(jnp.asarray(cot))
    xt = _nchw(x).requires_grad_(True)
    got = pfn(xt, *pargs)
    (got_g,) = torch.autograd.grad(got, xt, _nchw(cot)) if got.requires_grad \
        else (torch.zeros_like(xt),)
    assert tuple(_nhwc(got).shape) == want.shape
    _close(_nhwc(got), want, 1e-5, f"{case} output")
    _close(_nhwc(got_g), want_g, 1e-5, f"{case} input gradient")


# ---------------------------------------------------------------------------
# the fixed-genotype network
# ---------------------------------------------------------------------------

def _fixed_nets():
    kw = dict(c=4, num_classes=CLASSES, layers=3, auxiliary=True)
    return (J.DartsNetwork(genotype=J.DARTS_V2, **kw),
            P.DartsNetwork(genotype=P.DARTS_V2, **kw))


def _jax_keep_masks(masks):
    """The reference's ``_drop_path`` applying the given keep-masks
    (NHWC) in order, one a call, instead of drawing them."""
    it = iter(masks)

    def drop_path(x, rng, prob):
        keep = 1.0 - prob
        return x * jnp.asarray(next(it)).astype(x.dtype) / keep
    return drop_path


@pytest.fixture(scope="module")
def fixed_ref():
    """The reference's tiny fixed network (DARTS_V2, C=4, 3 cells, the
    auxiliary head) at 32x32x3, batch 4: its moved variables, evaluation
    logits, a training forward's logits, aux logits and new stats, the
    loss's gradients, and a training forward under drop-path 0.2 with
    fixed keep-masks."""
    jnet, pnet = _fixed_nets()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    y = (np.arange(B) % CLASSES).astype(np.int32)
    v = _perturb(jax.tree.map(np.asarray, jnet.init(
        jax.random.key(1), x, train=False)), 2)
    n_drop = pnet.drop_path_edges()
    keep = [rng.random((B, 1, 1, 1)) < 0.8 for _ in range(n_drop)]

    def train_fwd(p, xx):
        (lg, aux), mut = jnet.apply({"params": p,
                                     "batch_stats": v["batch_stats"]}, xx,
                                    train=True, mutable=["batch_stats"])
        return lg, aux, mut["batch_stats"]

    def loss(p):
        lg, aux, new_b = train_fwd(p, x)
        return (jsoftmax_ce(lg, y) + 0.4 * jsoftmax_ce(aux, y),
                (lg, aux, new_b))

    out = dict(v=v, x=x, y=y, keep=keep,
               eval=jax.jit(lambda p, b, xx: jnet.apply(
                   {"params": p, "batch_stats": b}, xx, train=False)[0])(
                   v["params"], v["batch_stats"], x))
    (out["loss"], out["train"]), out["grads"] = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v["params"])
    orig = J._drop_path
    J._drop_path = _jax_keep_masks([m.transpose(0, 2, 3, 1) for m in keep])
    try:
        out["drop"] = jax.jit(lambda p: jnet.apply(
            {"params": p, "batch_stats": v["batch_stats"]}, x, train=True,
            drop_path_prob=0.2, rngs={"droppath": jax.random.key(4)},
            mutable=["batch_stats"])[0][0])(v["params"])
    finally:
        J._drop_path = orig
    return jax.tree.map(np.asarray, out)


def test_fixed_network_weights_round_trip(fixed_ref):
    """flax -> port -> flax returns the identical trees; the names and
    shapes are exactly the port model's parameters and buffers
    (``FixedCell_0._Op_0.SepConv_0.Conv_0``, ``AuxiliaryHead_0``,
    ``_BN_0.BatchNorm_0``)."""
    v = fixed_ref["v"]
    _, pnet = _fixed_nets()
    params, bstats = params_from_flax(v["params"], v["batch_stats"])
    assert {k: tuple(t.shape) for k, t in params.items()} == \
        {k: tuple(t.shape) for k, t in pnet.named_parameters()}
    assert {k: tuple(t.shape) for k, t in bstats.items()} == \
        {k: tuple(t.shape) for k, t in pnet.named_buffers()}
    back_p, back_b = params_to_flax(params, bstats, v["params"],
                                    v["batch_stats"])
    for a, b in zip(jax.tree.leaves((back_p, back_b)),
                    jax.tree.leaves((v["params"], v["batch_stats"]))):
        np.testing.assert_array_equal(a, b)


def test_fixed_network_forward_grads_and_stats(fixed_ref):
    """Evaluation logits (running stats, no aux) rtol 1e-4 and 1e-4 of the
    largest; a training forward's logits and aux logits the same; the new
    running stats rtol 5e-4 (flax's E[x^2] - E[x]^2); the gradients of CE
    + 0.4 aux CE held as ``test_torch_zoo2d.py`` holds them (each leaf
    within 1e-2 of its L2 norm or 1e-5 of the largest leaf's norm)."""
    v, x, y = fixed_ref["v"], fixed_ref["x"], fixed_ref["y"]
    _, pnet = _fixed_nets()
    params, bstats = params_from_flax(v["params"], v["batch_stats"])
    xt = _nchw(x)
    lg, aux = functional_call(pnet, (params, bstats), (xt,),
                              {"train": False})
    assert aux is None
    _close(lg.detach().numpy(), fixed_ref["eval"], 1e-4, "eval logits")
    leaves = {k: t.clone().requires_grad_(True) for k, t in params.items()}
    new_b = {k: t.clone() for k, t in bstats.items()}
    lg, aux = functional_call(pnet, (leaves, new_b), (xt,), {"train": True})
    want_lg, want_aux, want_b = fixed_ref["train"]
    _close(lg.detach().numpy(), want_lg, 1e-4, "train logits")
    _close(aux.detach().numpy(), want_aux, 1e-4, "aux logits")
    _, ref_b = params_from_flax({}, want_b)
    for k, r in ref_b.items():
        np.testing.assert_allclose(new_b[k].numpy(), r.numpy(), rtol=5e-4,
                                   atol=1e-5, err_msg=k)
    yt = torch.from_numpy(y)
    loss = softmax_ce(lg, yt) + 0.4 * softmax_ce(aux, yt)
    assert float(loss.detach()) == pytest.approx(float(fixed_ref["loss"]),
                                                 rel=1e-4)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    ref_g, _ = params_from_flax(fixed_ref["grads"], {})
    floor = 1e-5 * max(float(g.norm()) for g in ref_g.values())
    for k, g in ref_g.items():
        err = float((grads[k] - g).norm())
        assert err <= max(1e-2 * float(g.norm()), floor), (k, err)


def test_fixed_network_drop_path(fixed_ref):
    """A training forward at drop-path 0.2 under the same keep-masks (one a
    non-identity edge, stride-2 ``skip_connect`` included): logits rtol
    1e-4 and 1e-4 of the largest. With no masks the probability 0 draws
    nothing; a probability above 0 draws from the generator."""
    v, x = fixed_ref["v"], fixed_ref["x"]
    _, pnet = _fixed_nets()
    params, bstats = params_from_flax(v["params"], v["batch_stats"])
    keep = [torch.from_numpy(m) for m in fixed_ref["keep"]]
    lg, _ = functional_call(pnet, (params, bstats), (_nchw(x),),
                            {"train": True, "drop_path_prob": 0.2,
                             "drop_path_masks": keep})
    _close(lg.detach().numpy(), fixed_ref["drop"], 1e-4, "drop-path logits")
    # DARTS_V2: a normal cell drops 6 of its 8 edges (two identity skips),
    # a reduction cell 5 (three stride-1 skips); cells 0, 1, 2 are normal,
    # reduction, reduction
    assert pnet.drop_path_edges() == len(keep) == 6 + 5 + 5
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    functional_call(pnet, (params, bstats), (_nchw(x),),
                    {"train": True, "generator": gen})
    assert torch.equal(gen.get_state(), before)
    functional_call(pnet, (params, bstats), (_nchw(x),),
                    {"train": True, "generator": gen,
                     "drop_path_prob": 0.2})
    assert not torch.equal(gen.get_state(), before)


# ---------------------------------------------------------------------------
# the search network
# ---------------------------------------------------------------------------

#: the smallest search net with both cell kinds: a normal cell, then two
#: reduction cells, each of one node (two mixed edges)
SEARCH_KW = dict(c=4, num_classes=CLASSES, layers=3, steps=1, multiplier=1)


def _jax_gumbel(draws):
    """The reference's ``_gumbel_hard`` with the given Gumbel draws, in
    call order (normal, then reduce), instead of its ``gumbel`` stream."""
    it = iter(draws)

    def gumbel_hard(logits, rng, tau):
        soft = jax.nn.softmax((logits + jnp.asarray(next(it))) / tau, -1)
        hard = jax.nn.one_hot(jnp.argmax(soft, -1), logits.shape[-1],
                              dtype=soft.dtype)
        return hard + soft - jax.lax.stop_gradient(soft)
    return gumbel_hard


@pytest.fixture(scope="module")
def search_ref():
    """The reference's tiny search net (C=4, 3 cells of 1 step) at
    16x16x3, batch 4, its params with alphas of N(0, 1): softmax logits
    and the CE's alpha gradients; GDAS (tau 0.5) logits and alpha
    gradients under fixed Gumbel draws; GDAS evaluation logits."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 16, 16, 3)).astype(np.float32)
    y = (np.arange(B) % CLASSES).astype(np.int32)
    jnet = J.DartsSearchNet(**SEARCH_KW)
    p = jax.tree.map(np.asarray, jnet.init(jax.random.key(1), x,
                                           train=False)["params"])
    for k in J.ARCH_KEYS:
        p[k] = rng.standard_normal(p[k].shape).astype(np.float32)
    p["_BN_0"] = jax.tree.map(np.asarray, _perturb({"_BN_0": p["_BN_0"]},
                                                   6)["_BN_0"])
    draws = [rng.gumbel(size=p[k].shape).astype(np.float32)
             for k in J.ARCH_KEYS]
    gnet = J.DartsSearchNet(gumbel=True, **SEARCH_KW)

    def ce(net, params, **kw):
        logits = net.apply({"params": params}, x, train=True, **kw)
        return jsoftmax_ce(logits, y), logits

    out = dict(p=p, x=x, y=y, draws=draws)
    (out["soft"], out["soft_logits"]), out["soft_g"] = jax.jit(
        jax.value_and_grad(lambda q: ce(jnet, q), has_aux=True))(p)
    orig = J._gumbel_hard
    J._gumbel_hard = _jax_gumbel(draws)
    try:
        (_, out["gdas_logits"]), out["gdas_g"] = jax.jit(jax.value_and_grad(
            lambda q: ce(gnet, q, tau=0.5,
                         rngs={"gumbel": jax.random.key(2)}),
            has_aux=True))(p)
    finally:
        J._gumbel_hard = orig
    out["gdas_eval"] = jax.jit(lambda q: gnet.apply(
        {"params": q}, x, train=False))(p)
    return jax.tree.map(np.asarray, out)


def test_search_net_softmax_forward_and_alpha_grads(search_ref):
    """The softmax mixture: the weights bridge carries the alphas as
    top-level leaves and no ``batch_stats``; training logits (search-mode
    BatchNorm: the batch's statistics) and evaluation logits rtol 1e-4
    and 1e-4 of the largest, equal to each other; the CE's gradient with
    respect to every leaf, the alphas included, within 1e-2 of the leaf's
    L2 norm (``test_torch_zoo2d.py``'s rule)."""
    p, x, y = search_ref["p"], search_ref["x"], search_ref["y"]
    pnet = P.DartsSearchNet(**SEARCH_KW)
    params, bstats = params_from_flax(p, {})
    assert bstats == {} and list(pnet.named_buffers()) == []
    assert {k: tuple(t.shape) for k, t in params.items()} == \
        {k: tuple(t.shape) for k, t in pnet.named_parameters()}
    leaves = {k: t.clone().requires_grad_(True) for k, t in params.items()}
    lg = functional_call(pnet, leaves, (_nchw(x),), {"train": True})
    ev = functional_call(pnet, params, (_nchw(x),), {"train": False})
    _close(lg.detach().numpy(), search_ref["soft_logits"], 1e-4, "train")
    np.testing.assert_array_equal(ev.numpy(), lg.detach().numpy())
    loss = softmax_ce(lg, torch.from_numpy(y))
    assert float(loss.detach()) == pytest.approx(float(search_ref["soft"]),
                                                 rel=1e-4)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    ref_g, _ = params_from_flax(search_ref["soft_g"], {})
    floor = 1e-5 * max(float(g.norm()) for g in ref_g.values())
    for k, g in ref_g.items():
        err = float((grads[k] - g).norm())
        assert err <= max(1e-2 * float(g.norm()), floor), (k, err)


def test_search_net_gdas(search_ref):
    """GDAS at tau 0.5 under the same Gumbel draws: the one-hot forward's
    logits rtol 1e-4 and 1e-4 of the largest, the straight-through
    gradient with respect to both alphas within 1e-3 of its L2 norm; in
    evaluation the noise-free argmax one-hot (no draw), as the
    reference's."""
    p, x, y = search_ref["p"], search_ref["x"], search_ref["y"]
    pnet = P.DartsSearchNet(gumbel=True, **SEARCH_KW)
    params, _ = params_from_flax(p, {})
    leaves = {k: t.clone().requires_grad_(True) for k, t in params.items()}
    draws = tuple(torch.from_numpy(d) for d in search_ref["draws"])
    lg = functional_call(pnet, leaves, (_nchw(x),),
                         {"train": True, "tau": 0.5, "gumbel_draws": draws})
    _close(lg.detach().numpy(), search_ref["gdas_logits"], 1e-4, "gdas")
    loss = softmax_ce(lg, torch.from_numpy(y))
    got = torch.autograd.grad(loss, [leaves[k] for k in P.ARCH_KEYS])
    for k, g in zip(P.ARCH_KEYS, got):
        want = torch.from_numpy(np.array(search_ref["gdas_g"][k]))
        assert float((g - want).norm()) <= 1e-3 * float(want.norm()), k
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    ev = functional_call(pnet, params, (_nchw(x),),
                         {"train": False, "generator": gen})
    assert torch.equal(gen.get_state(), before)
    _close(ev.numpy(), search_ref["gdas_eval"], 1e-4, "gdas eval")


@pytest.mark.parametrize("kind", ["seeded", "tied", "tied_rows"])
def test_derive_genotype_matches_reference(kind):
    """``derive_genotype`` of the reference's 4-step cells (14 edges) on
    seeded alphas, on all-zero alphas (every weight tied) and on alphas
    whose rows repeat (tied best edges, tied ops): the same genotype, so
    the stable sort on ``-best`` and the first maximum break ties
    alike."""
    rng = np.random.default_rng(11)
    k = J.num_edges(4)
    if kind == "seeded":
        an, ar = (1e-3 * rng.standard_normal((k, 8)).astype(np.float32)
                  for _ in range(2))
    elif kind == "tied":
        an = ar = np.zeros((k, 8), np.float32)
    else:
        row = np.round(rng.standard_normal(8), 1).astype(np.float32)
        row[5] = row[6] = row.max()
        an = np.tile(row, (k, 1))
        ar = np.tile(row[::-1], (k, 1))
    want = J.derive_genotype(an, ar)
    got = P.derive_genotype(torch.from_numpy(an), torch.from_numpy(ar))
    assert tuple(got) == tuple(want)
    assert P.derive_genotype(an, ar, steps=4, multiplier=4) == got


# ---------------------------------------------------------------------------
# the architect and the drivers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def search_batches(search_ref):
    rng = np.random.default_rng(9)
    xv = rng.standard_normal((B, 16, 16, 3)).astype(np.float32)
    yv = ((np.arange(B) + 3) % CLASSES).astype(np.int32)
    return (search_ref["x"], search_ref["y"]), (xv, yv)


def test_arch_grads_match_reference(search_ref, search_batches):
    """FedNAS's first-order regularized arch gradient (lambdas 0.5 and 1)
    against the reference's: each alpha's gradient within 1e-3 of its L2
    norm (measured 1.2e-6). The exact unrolled gradient is held against
    the reference's inside ``DartsSearch`` (next test); here, at ``eta`` 0
    the inner step is the identity, so it must equal the validation
    batch's first-order gradient (rtol 1e-6: the same float32 program),
    and away from 0 it differs from it."""
    jnet = J.DartsSearchNet(**SEARCH_KW)
    pnet = P.DartsSearchNet(**SEARCH_KW)
    (x, y), (xv, yv) = search_batches
    p = search_ref["p"]

    def jloss(q, batch):
        return jsoftmax_ce(jnet.apply({"params": q}, batch[0], train=True),
                           batch[1])

    want = jax.jit(lambda q: J.arch_grad_regularized(
        jloss, q, (x, y), (xv, yv), lambda_train=0.5))(p)

    def ploss(q, batch):
        return softmax_ce(functional_call(pnet, q, (_nchw(batch[0]),),
                                          {"train": True}),
                          torch.from_numpy(batch[1]))

    params, _ = params_from_flax(p, {})
    got = P.arch_grad_regularized(ploss, params, (x, y), (xv, yv),
                                  lambda_train=0.5)
    assert set(got) == set(P.ARCH_KEYS)
    for k in P.ARCH_KEYS:
        ref = torch.from_numpy(np.asarray(want[k]))
        assert float((got[k] - ref).norm()) <= 1e-3 * float(ref.norm()), k
    val_only = P.arch_grad_regularized(ploss, params, (x, y), (xv, yv),
                                       lambda_train=0.0)
    at_zero = P.arch_grad_unrolled(ploss, params, (x, y), (xv, yv), 0.0)
    moved = P.arch_grad_unrolled(ploss, params, (x, y), (xv, yv), 0.5)
    for k in P.ARCH_KEYS:
        torch.testing.assert_close(at_zero[k], val_only[k], rtol=1e-6,
                                   atol=1e-6 * float(val_only[k].abs().max()))
        assert not torch.allclose(moved[k], val_only[k])


@pytest.mark.parametrize("unrolled", [False, True],
                         ids=["first_order", "unrolled"])
def test_darts_search_two_steps(search_ref, search_batches, unrolled):
    """Two ``DartsSearch`` steps (4 total steps of the cosine schedule, arch
    Adam then the clipped SGD of the weights) from the reference's params.
    After each step the architect's Adam first moment, ``(1 - b1) * (g +
    wd * a) + b1 * mu``, holds that step's arch gradient ``g`` (under
    ``unrolled`` the exact gradient through the inner step at the step's
    lr and the momentum trace): within 1e-3 of its L2 norm of the
    reference's (measured: up to 1.9e-6 first order, 1.4e-6 unrolled). Each
    step's train loss rtol 1e-4, the weights at ``TRAJECTORY``, the alphas
    within 1e-3 of their largest change; the derived genotype is the
    reference's."""
    jnet = J.DartsSearchNet(**SEARCH_KW)
    pnet = P.DartsSearchNet(**SEARCH_KW)
    (x, y), (xv, yv) = search_batches
    p = {**search_ref["p"]}
    for k in J.ARCH_KEYS:
        p[k] = p[k] * 1e-3
    js = J.DartsSearch(jnet, CLASSES, total_steps=4, unrolled=unrolled)
    ja, jw = J.split_arch(jax.tree.map(jnp.asarray, p))
    jstate = {"params": J.merge_arch(ja, jw), "w_opt": js.w_opt.init(jw),
              "a_opt": js.a_opt.init(ja), "step": jnp.zeros((), jnp.int32)}
    ps = P.DartsSearch(pnet, CLASSES, total_steps=4, unrolled=unrolled)
    params, _ = params_from_flax(p, {})
    init = {k: t.clone() for k, t in params.items()}
    state = ps.init(torch.Generator(), params=params)
    batches = ((torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                torch.from_numpy(y)),
               (torch.from_numpy(xv.transpose(0, 3, 1, 2).copy()),
                torch.from_numpy(yv)))
    for _ in range(2):
        jstate, jl = js.step(jstate, (x, y), (xv, yv))
        state, loss = ps.step(state, *batches)
        assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
        mu = jstate["a_opt"][1].mu
        for k in P.ARCH_KEYS:
            ref = torch.from_numpy(np.asarray(mu[k]))
            err = float((state["a_opt"].mu[k] - ref).norm())
            assert err <= 1e-3 * float(ref.norm()), (k, err)
    assert state["step"] == 2
    ref = jax.tree.map(np.asarray, jstate["params"])
    ref_a, ref_w = J.split_arch(ref)
    got_a, got_w = P.split_arch(state["params"])
    init_a, init_w = P.split_arch(init)
    assert_state_close(got_w, {}, ref_w, {}, init_w, **TRAJECTORY)
    moved = max(float((torch.from_numpy(ref_a[k]) - init_a[k]).abs().max())
                for k in P.ARCH_KEYS)
    assert moved > 0
    for k in P.ARCH_KEYS:
        np.testing.assert_allclose(got_a[k].numpy(), ref_a[k], rtol=0,
                                   atol=1e-3 * moved, err_msg=k)
    assert tuple(ps.genotype(state)) == tuple(js.genotype(jstate))


def test_darts_trainer_two_steps(fixed_ref):
    """Two ``DartsTrainer`` steps (CE + 0.4 aux CE, clip 5, momentum 0.9,
    wd 3e-4, cosine lr over 4 steps, drop-path 0.2 x step / 4) from the
    reference's variables under the same keep-masks both steps: each
    loss rtol 1e-4, the weights and running stats at ``TRAJECTORY``;
    the stats move."""
    jnet, pnet = _fixed_nets()
    v, x, y = fixed_ref["v"], fixed_ref["x"], fixed_ref["y"]
    keep = fixed_ref["keep"]
    jt = J.DartsTrainer(jnet, CLASSES, total_steps=4)
    jstate = jt.init(jax.random.key(0), x)
    jstate["variables"] = jax.tree.map(jnp.asarray, v)
    jstate["opt"] = jt.opt.init(jstate["variables"]["params"])
    pt = P.DartsTrainer(pnet, CLASSES, total_steps=4)
    params, bstats = params_from_flax(v["params"], v["batch_stats"])
    init_p = {k: t.clone() for k, t in params.items()}
    init_b = {k: t.clone() for k, t in bstats.items()}
    state = pt.init(torch.Generator(), params=params, bstats=bstats)
    batch = (_nchw(x), torch.from_numpy(y))
    orig = J._drop_path
    J._drop_path = _jax_keep_masks([m.transpose(0, 2, 3, 1) for m in keep]
                                   * 2)
    try:
        for _ in range(2):
            jstate, jl = jt.step(jstate, (x, y), jax.random.key(3))
            state, loss = pt.step(state, batch, drop_path_masks=[
                torch.from_numpy(m) for m in keep])
            assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    finally:
        J._drop_path = orig
    assert state["step"] == 2
    ref = jax.tree.map(np.asarray, jstate["variables"])
    assert_state_close(state["params"], state["bstats"], ref["params"],
                       ref["batch_stats"], init_p, **TRAJECTORY)
    assert any(not torch.equal(state["bstats"][k], init_b[k])
               for k in init_b)
    assert pt.drop_prob(1) == pytest.approx(0.05) and pt.drop_prob(9) == \
        pytest.approx(0.2)


# ---------------------------------------------------------------------------
# full width: the leaf trees the federation steps
# ---------------------------------------------------------------------------

#: leaves, parameters, maskable kernels and batch_stats leaves of each
#: model at 32x32x3 and 10 classes (the reference's ``jax.eval_shape``)
FULL = {"darts": (919, 3_349_342, 440, 478),
        "fednas_v1": (1231, 4_279_870, 596, 634),
        "darts_search": (1401, 1_930_842, 1396, 0)}


@pytest.mark.parametrize("name", list(FULL))
def test_full_width_leaves_and_mask_order(name):
    """At full width (C=36 and 20 cells; the search net C=16 and 8 cells):
    the port's parameters are the reference's leaves one for one (names
    through ``weights.py``, shapes in the port's layout), and the maskable
    leaves (``*kernel`` of rank >= 2) come in the reference's flatten
    order: ``FixedCell_10`` ... ``FixedCell_19`` before ``FixedCell_2``,
    as a string sort of the module paths puts them. The search net's
    alphas are not maskable."""
    from neuroimagedisttraining_tpu.models import create_model as jcreate
    from neuroimagedisttraining_tpu_torch.models import create_model
    from neuroimagedisttraining_tpu_torch.ops.masks import maskable_names
    from neuroimagedisttraining_tpu_torch.weights import (
        _PARAM_NAMES, _STAT_NAMES, _port_name, _to_torch_layout,
    )

    v = jax.eval_shape(lambda: jcreate(name, num_classes=CLASSES).init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
    pm = create_model(name, (32, 32, 3), CLASSES)
    flat = jax.tree_util.tree_flatten_with_path(v["params"])[0]
    paths = [tuple(p.key for p in path) for path, _ in flat]
    names = [_port_name(p[:-1], p[-1], _PARAM_NAMES) for p in paths]
    port = dict(pm.named_parameters())
    assert names == sorted(port, key=names.index) and set(names) == set(port)
    for n, (path, leaf) in zip(names, flat):
        shape = _to_torch_layout(path[-1].key, np.empty(leaf.shape)).shape
        assert tuple(port[n].shape) == shape, n
    leaves, n_params, n_mask, n_stats = FULL[name]
    stats = jax.tree_util.tree_flatten_with_path(v.get("batch_stats", {}))[0]
    assert {_port_name(tuple(p.key for p in path[:-1]), path[-1].key,
                       _STAT_NAMES) for path, _ in stats} == \
        set(dict(pm.named_buffers()))
    assert (len(port), sum(t.numel() for t in port.values()), len(stats)) \
        == (leaves, n_params, n_stats)
    ref_order = [n for (path, leaf), n in zip(flat, names)
                 if path[-1].key == "kernel" and len(leaf.shape) >= 2]
    assert len(ref_order) == n_mask
    assert maskable_names(port) == ref_order
    if name != "darts_search":
        assert ref_order.index("FixedCell_19._Op_0.SepConv_0.Conv_0.weight") \
            < ref_order.index("FixedCell_2.ReLUConvBN_0.Conv_0.weight")
