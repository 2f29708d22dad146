"""The port's fault schedule and Byzantine attacks against the reference
package's: the ``--fault_spec`` grammar accepts and refuses the same
strings, the seeded schedule's trace, survivors and Byzantine kinds are
bit-equal over 50 rounds x 8 ranks, the attack plans equal, and
``apply_attack_stacked`` equals the reference's for every kind on stacked
random trees (the reference's Gaussian draws passed in), honest rows bit
for bit untouched."""

import jax
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.faults import adversary as jadv
from neuroimagedisttraining_tpu.faults import schedule as jsched
from neuroimagedisttraining_tpu_torch.faults import adversary as padv
from neuroimagedisttraining_tpu_torch.faults import schedule as psched

GOOD = ["", "crash:3@1", "crash:3@1,rejoin:3@4", "crash_prob:0.1",
        "straggle:0.2:1.5", "drop:0.1;dup:0.05", "disconnect:0.3",
        "byz:1@0:sign_flip", "byz:2@3:scale:-4", "byz:1@0:gauss:0.5",
        "byz:4@2:nonfinite", "byz_prob:0.2", "byz_prob:0.3:scale:2",
        "preempt:2@3", "crash:1@0, byz:2@1:gauss:0.1 ,drop:0.2"]
BAD = ["crash:x@1", "boom:1", "byz:1@0", "byz:1@0:nope", "byz:1@0:scale",
       "byz:1@0:gauss:-1", "byz:1@0:sign_flip:3", "drop:1.5",
       "crash_prob:-0.1", "rejoin:3@4", "crash:3@4,rejoin:3@4",
       "preempt:0@1", "straggle:0.1"]
SPECS = ["crash:3@1,rejoin:3@4,crash_prob:0.05,byz:2@3:scale:-4,"
         "byz_prob:0.1:gauss:0.5,straggle:0.3:2,drop:0.2,dup:0.1,"
         "disconnect:0.05", "byz:1@0:sign_flip,crash:5@2",
         "crash_prob:0.2,byz_prob:0.4:nonfinite"]


@pytest.mark.parametrize("text", GOOD)
def test_parse_accepts_as_reference(text):
    got, ref = psched.parse_fault_spec(text), jsched.parse_fault_spec(text)
    assert vars(got) == vars(ref)
    assert (got.any_faults, got.any_value_faults) == (
        ref.any_faults, ref.any_value_faults)


@pytest.mark.parametrize("text", BAD)
def test_parse_refuses_as_reference(text):
    with pytest.raises(ValueError) as ref:
        jsched.parse_fault_spec(text)
    with pytest.raises(ValueError) as got:
        psched.parse_fault_spec(text)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("text", SPECS)
def test_schedule_bit_equal_over_50_rounds(text):
    """Trace, survivors, Byzantine kinds, crash rounds and the activity
    mask equal the reference's for 50 rounds x 8 ranks."""
    got = psched.FaultSchedule(psched.parse_fault_spec(text), 7)
    ref = jsched.FaultSchedule(jsched.parse_fault_spec(text), 7)
    ranks = range(1, 9)
    assert got.trace(50, ranks) == ref.trace(50, ranks)
    for r in range(50):
        ids = np.arange(8)
        np.testing.assert_array_equal(got.survivors(r, ids),
                                      ref.survivors(r, ids))
        np.testing.assert_array_equal(got.active_mask(r, 8, 0.7),
                                      ref.active_mask(r, 8, 0.7))
        for k in ranks:
            assert got.byzantine_kind(r, k) == ref.byzantine_kind(r, k)
    for k in ranks:
        assert got.crash_round(k, 50) == ref.crash_round(k, 50)
    assert got.describe() == ref.describe()


@pytest.mark.parametrize("text", SPECS)
def test_plan_arrays_equal(text):
    got = psched.FaultSchedule(psched.parse_fault_spec(text), 3)
    ref = jsched.FaultSchedule(jsched.parse_fault_spec(text), 3)
    for r in range(10):
        for a, b in zip(padv.plan_arrays(got, r, np.arange(1, 9)),
                        jadv.plan_arrays(ref, r, np.arange(1, 9))):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def _trees(C, seed=0):
    """A stacked upload {params, batch_stats} of C clients and its
    broadcast reference, as flax-style nested numpy trees."""
    rng = np.random.default_rng(seed)
    shapes = {"params": {"a": {"kernel": (3, 4)}, "b": {"bias": (5,)}},
              "batch_stats": {"bn": {"mean": (4,), "var": (4,)}}}

    def make(lead):
        return jax.tree.map(lambda s: rng.normal(size=lead + s).astype(
            np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))

    return make((C,)), make(())


def _flat(tree):
    """Flax-ordered (path, leaf) pairs of a nested tree."""
    return [("/".join(str(p.key) for p in path), leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)]


KINDS = ["sign_flip", "scale:2.5", "gauss:0.3", "nonfinite", None]


@pytest.mark.parametrize("kind", KINDS[:-1])
def test_apply_attack_stacked_equals_reference(kind):
    """Clients 1 and 3 attack with ``kind``, clients 0, 2, 4 are honest;
    the reference's noise (fold_in(key, leaf index) in flax leaf order)
    passed in. Attacked rows rtol 1e-6 (one float32 rounding of the same
    formula); honest rows bit for bit the input tensors themselves."""
    C = 5
    stacked, ref = _trees(C)
    kinds = [None, kind, None, kind, None]
    plan = [jadv.kind_params(k) for k in kinds]
    mult = np.asarray([p[0] for p in plan], np.float32)
    std = np.asarray([p[1] for p in plan], np.float32)
    nan = np.asarray([p[2] for p in plan], bool)
    keys = jadv.attack_keys(11, 2, np.arange(1, C + 1))
    want = jax.tree.map(np.asarray, jadv.apply_attack_stacked(
        stacked, ref, mult, std, nan, keys))
    names = [n for n, _ in _flat(ref)]
    ref_t = {n: torch.from_numpy(v) for n, v in _flat(ref)}
    ups = [{n: torch.from_numpy(np.ascontiguousarray(v[c]))
            for n, v in _flat(stacked)} for c in range(C)]
    noises = []
    for c in range(C):
        noises.append({n: torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(keys[c], i), ref_t[n].shape)))
            for i, n in enumerate(names)})
    got = padv.apply_attack_stacked(ups, ref_t, mult, std, nan, noises)
    wflat = dict(_flat(want))
    for c in range(C):
        for n in names:
            w = wflat[n][c]
            if kinds[c] is None:
                assert got[c][n] is ups[c][n]  # untouched, not recomputed
                np.testing.assert_array_equal(got[c][n].numpy(), w)
            elif kind == "nonfinite":
                assert np.isnan(got[c][n].numpy()).all() and np.isnan(w).all()
            else:
                np.testing.assert_allclose(got[c][n].numpy(), w, rtol=1e-6,
                                           atol=1e-7)


def test_kind_params_equal():
    for k in KINDS + ["scale:-4.0", "gauss:0.0"]:
        assert padv.kind_params(k) == jadv.kind_params(k)
    with pytest.raises(ValueError):
        padv.kind_params("boom")
    assert psched.BYZ_KINDS == jsched.BYZ_KINDS
    for k in ("sign_flip", "scale:3", "gauss:0.25", "nonfinite"):
        assert psched.parse_byz_kind(k) == jsched.parse_byz_kind(k)
