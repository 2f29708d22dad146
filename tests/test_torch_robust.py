"""The port's defenses (``core/robust.py``) against the reference
package's on stacked random upload trees with outliers, tied rows,
zero-weight rows and even and odd cohorts: every defense through
``aggregate_with_defense``, Krum and multi-Krum selecting the same
clients, the geometric median within rtol 1e-5 (8 Weiszfeld steps of
float32 sums in another order), the order statistics within 1e-6 of the
largest entry (the same sort, sums in another order), the clip family and
weak DP (the reference's noise passed in) within 1e-6, the non-finite
guard exactly, ``effective_defense``'s fallbacks and ``_check_f``'s
errors word for word."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.core import robust as jr
from neuroimagedisttraining_tpu_torch.core import robust as pr

SHAPES = {"params": {"conv": {"kernel": (3, 3, 2, 4), "bias": (4,)},
                     "dense": {"kernel": (6, 2)}},
          "batch_stats": {"bn": {"mean": (4,), "var": (4,)}}}


def _cohort(C, seed=0, outliers=(), ties=()):
    """A stacked upload of C clients near a broadcast reference: client
    updates of scale 1e-2, ``outliers`` moved by 50, each ``(a, b)`` of
    ``ties`` a copy of client a's row at b. Numpy nested trees."""
    rng = np.random.default_rng(seed)
    ref = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                       SHAPES, is_leaf=lambda x: isinstance(x, tuple))

    def leaf(r):
        x = r[None] + 1e-2 * rng.normal(size=(C,) + r.shape).astype(
            np.float32)
        for o in outliers:
            x[o] = r + 50.0 * rng.normal(size=r.shape).astype(np.float32)
        for a, b in ties:
            x[b] = x[a]
        return x

    return jax.tree.map(leaf, ref), ref


def _named(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_list(stacked):
    named = _named(stacked)
    C = next(iter(named.values())).shape[0]
    return [{n: torch.from_numpy(np.ascontiguousarray(v[c]))
             for n, v in named.items()} for c in range(C)]


def _port(tree):
    return {n: torch.from_numpy(v.copy()) for n, v in _named(tree).items()}


def _close(got: dict, ref_tree, rtol=0.0, atol_rel=1e-6):
    for n, v in _named(ref_tree).items():
        atol = atol_rel * max(float(np.abs(v).max()), 1e-30)
        np.testing.assert_allclose(got[n].numpy(), v, rtol=rtol, atol=atol,
                                   err_msg=n)


COHORTS = {
    "odd_outliers": dict(C=5, outliers=(1,), w=[3, 2, 0, 4, 1]),
    "even_ties": dict(C=6, outliers=(4,), ties=((0, 2),),
                      w=[2, 2, 2, 2, 1, 3]),
    "even_zero_weights": dict(C=8, outliers=(0, 5), ties=((2, 6),),
                              w=[1, 0, 3, 1, 2, 0, 1, 4]),
}
AGGREGATORS = ["trimmed_mean", "median", "krum", "multi_krum",
               "geometric_median"]


@pytest.mark.parametrize("cohort", list(COHORTS))
@pytest.mark.parametrize("defense", AGGREGATORS + ["none",
                                                   "norm_diff_clipping"])
def test_defense_equals_reference(defense, cohort):
    spec = COHORTS[cohort]
    stacked, ref = _cohort(spec["C"], outliers=spec["outliers"],
                           ties=spec.get("ties", ()))
    w = np.asarray(spec["w"], np.float32)
    want = jax.tree.map(np.asarray, jr.aggregate_with_defense(
        stacked, ref, jnp.asarray(w), defense=defense, norm_bound=0.05,
        byz_f=1, geomed_iters=8))
    got = pr.aggregate_with_defense(
        _port_list(stacked), _port(ref), torch.from_numpy(w),
        defense=defense, norm_bound=0.05, byz_f=1, geomed_iters=8)
    if defense == "geometric_median":
        _close(got, want, rtol=1e-5, atol_rel=1e-6)
    else:
        _close(got, want)


@pytest.mark.parametrize("cohort", list(COHORTS))
@pytest.mark.parametrize("multi", [False, True])
def test_krum_selects_the_same_clients(cohort, multi):
    """Equal indices. The cohorts tie identical rows only: two different
    rows whose Krum scores tie in exact arithmetic (two pairs of copies
    give four equal scores) are told apart by the float32 rounding of
    ``|a|^2 + |b|^2 - 2 a.b``, which XLA's and torch's products round
    differently, so neither package's pick among them is a contract."""
    spec = COHORTS[cohort]
    stacked, _ = _cohort(spec["C"], outliers=spec["outliers"],
                         ties=spec.get("ties", ()))
    w = np.asarray(spec["w"], np.float32)
    C = spec["C"]
    m = max(1, C - 3) if multi else 1
    want = np.asarray(jr.krum_select(stacked, jnp.asarray(w), 1, m))
    got = pr.krum_select(_port_list(stacked), torch.from_numpy(w), 1, m)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not set(spec["outliers"]) & set(want.tolist())


def test_weak_dp_with_the_reference_noise():
    """Clip then per-client noise: the reference's draws (a split of each
    client's key over the leaves in flax order) passed in, rtol 1e-6."""
    stacked, ref = _cohort(4, seed=3, outliers=(2,))
    params, ref_p = stacked["params"], ref["params"]
    keys = jax.random.split(jax.random.key(5), 4)
    want = jax.tree.map(np.asarray, jr.defend_stacked(
        params, ref_p, defense="weak_dp", norm_bound=0.03, stddev=0.05,
        rngs=keys))
    names = list(_named(ref_p))
    noises = []
    for c in range(4):
        ks = jax.random.split(keys[c], len(names))
        noises.append({n: torch.from_numpy(np.array(jax.random.normal(
            k, _named(ref_p)[n].shape, jnp.float32)))
            for n, k in zip(names, ks)})
    got = pr.defend_stacked(_port_list(params), _port(ref_p),
                            defense="weak_dp", norm_bound=0.03, stddev=0.05,
                            noises=noises)
    wn = _named(want)
    for c in range(4):
        for n in names:
            np.testing.assert_allclose(got[c][n].numpy(), wn[n][c],
                                       rtol=1e-6, atol=1e-6, err_msg=n)
    with pytest.raises(ValueError):
        pr.defend_stacked(_port_list(params), _port(ref_p),
                          defense="weak_dp", norm_bound=1.0, stddev=0.1)


def test_norm_diff_clip_equals_reference():
    stacked, ref = _cohort(3, seed=1, outliers=(0,))
    p = jax.tree.map(lambda x: x[0], stacked["params"])
    for bound in (0.01, 1e6):
        want = jax.tree.map(np.asarray, jr.norm_diff_clip(p, ref["params"],
                                                          bound))
        got = pr.norm_diff_clip(_port(p), _port(ref["params"]), bound)
        _close(got, want)


def test_nonfinite_guard_equals_reference():
    stacked, ref = _cohort(4, seed=2)
    stacked["params"]["conv"]["bias"][1, 2] = np.nan
    stacked["batch_stats"]["bn"]["var"][3, 0] = np.inf
    want_f = np.asarray(jr.finite_per_client(stacked))
    ups = _port_list(stacked)
    got_f = pr.finite_per_client(ups)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    want = _named(jax.tree.map(np.asarray, jr.replace_nonfinite_clients(
        stacked, ref, jnp.asarray(want_f))))
    got = pr.replace_nonfinite_clients(ups, _port(ref), got_f)
    for c in range(4):
        for n, v in want.items():
            np.testing.assert_array_equal(got[c][n].numpy(), v[c])


@pytest.mark.parametrize("defense", AGGREGATORS)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7])
@pytest.mark.parametrize("f", [0, 1, 2])
def test_effective_defense_and_check_f(defense, n, f):
    """Fallbacks to ``none`` and Blanchard warnings as the reference's,
    and ``_check_f``'s errors word for word."""
    jw, pw = [], []
    assert pr.effective_defense(defense, n, f, warn=lambda *a: pw.append(a)) \
        == jr.effective_defense(defense, n, f, warn=lambda *a: jw.append(a))
    assert [a[0] % a[1:] for a in pw] == [a[0] % a[1:] for a in jw]
    try:
        jr._check_f(n, f, defense)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pr._check_f(n, f, defense)
        assert str(got.value) == str(e)
    else:
        assert pr._check_f(n, f, defense) == f
    with pytest.raises(ValueError) as got:
        pr._check_f(n, -1, defense)
    assert "byz_f must be >= 0" in str(got.value)


def test_names_and_validation():
    assert pr.DEFENSES == jr.DEFENSES
    assert pr.ROBUST_AGGREGATORS == jr.ROBUST_AGGREGATORS
    assert pr.CLIP_DEFENSES == jr.CLIP_DEFENSES
    with pytest.raises(ValueError) as got:
        pr.validate_defense("bulyan")
    with pytest.raises(ValueError) as ref:
        jr.validate_defense("bulyan")
    assert str(got.value) == str(ref.value)


def test_all_zero_weights_fall_back_as_reference():
    """Every client sanitized: trimmed mean and median vote uniformly,
    Krum selects uniformly, the geometric median weighs uniformly."""
    stacked, ref = _cohort(5, seed=4, outliers=(3,))
    w = np.zeros(5, np.float32)
    for defense in AGGREGATORS:
        want = jax.tree.map(np.asarray, jr.robust_aggregate(
            stacked, jnp.asarray(w), defense=defense, byz_f=1))
        got = pr.robust_aggregate(_port_list(stacked), torch.from_numpy(w),
                                  defense=defense, byz_f=1)
        _close(got, want, rtol=1e-5 if defense == "geometric_median" else 0)


def test_unweighted_median_equals_reference():
    stacked, _ = _cohort(6, seed=5, outliers=(1,))
    want = jax.tree.map(np.asarray, jr.coordinate_median(stacked))
    _close(pr.coordinate_median(_port_list(stacked)), want)
