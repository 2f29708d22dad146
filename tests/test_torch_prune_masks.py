"""The sparse engines' ops held against the reference package's on the same
inputs (made from a seed with numpy), at AlexNet3D's flagship leaf shapes
(121x145x121) and at small shapes: Sub-FedAvg's ``ops/prune.py`` and
DisPFL's ``ops/masks.py`` (ERK sparsities, initial masks, fire and regrow,
Hamming distances), its activity draw and its neighbour graph.

The reference's functions run jitted, as its engines run them, and where
XLA's compiler rewrites an expression (it folds a division by a constant
into a product, or a constant into another) also op by op
(``jax.disable_jit``). The port computes each operation rounded on its own;
where that differs from the jitted reference the test says how, and that
the masks (the decisions) are still equal."""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.config import (
    ExperimentConfig as JExp, FedConfig as JFed,
)
from neuroimagedisttraining_tpu.engines.dispfl import (
    DisPFLEngine as JDisPFL,
)
from neuroimagedisttraining_tpu.faults.schedule import (
    activity_mask as j_activity_mask,
)
from neuroimagedisttraining_tpu.ops import masks as JM
from neuroimagedisttraining_tpu.ops import prune as JP
from neuroimagedisttraining_tpu_torch.config import (
    ExperimentConfig, FedConfig,
)
from neuroimagedisttraining_tpu_torch.engines.dispfl import DisPFLEngine
from neuroimagedisttraining_tpu_torch.faults.schedule import activity_mask
from neuroimagedisttraining_tpu_torch.models import create_model
from neuroimagedisttraining_tpu_torch.ops import masks as PM
from neuroimagedisttraining_tpu_torch.ops import prune as PP
from neuroimagedisttraining_tpu_torch.weights import masks_from_flax

FLAGSHIP = (121, 145, 121)
#: small leaves with the model's naming: two convs, a BN, a dense layer
SMALL = {"a.conv.weight": (6, 3, 3, 3, 3), "a.conv.bias": (6,),
         "a.bn.weight": (6,), "a.bn.bias": (6,),
         "b.conv.weight": (4, 6, 1, 2, 3), "b.conv.bias": (4,),
         "fc.weight": (5, 40), "fc.bias": (5,)}


def shapes_of(kind: str) -> dict[str, tuple]:
    if kind == "small":
        return dict(SMALL)
    return {k: tuple(v.shape) for k, v in
            create_model("3dcnn", FLAGSHIP).named_parameters()}


def flax_name(name: str) -> str:
    """The reference's leaf path of a port parameter name."""
    *mods, leaf = name.split(".")
    return "/".join(mods + ["kernel" if leaf == "weight" and
                            not mods[-1].startswith("bn") else
                            ("scale" if leaf == "weight" else leaf)])


def to_flax(state: dict[str, torch.Tensor]) -> dict:
    """A port state dict as the reference's nested tree (flax layouts)."""
    out: dict = {}
    for k, v in state.items():
        *mods, leaf = flax_name(k).split("/")
        a = v.numpy()
        if leaf == "kernel":
            a = (np.transpose(a, (2, 3, 4, 1, 0)) if a.ndim == 5 else a.T)
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(np.ascontiguousarray(a))
    return out


def from_flax_masks(tree) -> dict[str, torch.Tensor]:
    return masks_from_flax(jax.tree.map(np.asarray, tree))


def weights(shapes, rng, ties: bool = False) -> dict[str, torch.Tensor]:
    """Gaussian weights; with ``ties`` quantized to 1/16 so that many |w|
    are equal; biases exactly 0 in half the entries."""
    out = {}
    for k, s in shapes.items():
        w = rng.standard_normal(s).astype(np.float32)
        if ties:
            w = np.round(w * 16) / 16
        if k.endswith("bias"):
            w[::2] = 0.0
        out[k] = torch.from_numpy(w.astype(np.float32))
    return out


def masks(shapes, rng, keep: float = 0.7, empty: str | None = None):
    """0/1 masks keeping about ``keep`` of each maskable leaf (ones
    elsewhere); ``empty`` names a leaf whose mask keeps nothing."""
    out = {}
    for k, s in shapes.items():
        m = (rng.random(s) < keep) if len(s) >= 2 else np.ones(s, bool)
        if k == empty:
            m[...] = False
        out[k] = torch.from_numpy(m.astype(np.float32))
    return out


def assert_masks_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


# ---------------------------------------------------------------- prune

@pytest.mark.parametrize("kind", ["small", "alexnet"])
@pytest.mark.parametrize("ratio", [0.1, 0.0, 1.0])
def test_fake_prune_masks_bit_equal(kind, ratio):
    """``fake_prune`` on weights with ties and masks with dead entries (the
    small case with one layer's alive set empty): the masks equal the
    jitted reference's bit for bit, dead entries stay dead, the empty
    layer keeps its mask. Each layer's threshold equals the reference's
    run op by op bit for bit; against the jitted reference it is equal or
    one ulp off (XLA may contract ``v_lo + frac * (v_hi - v_lo)`` into an
    FMA) and, where one ulp off, no |w| lies between the two values. (It
    was bit-equal to the jitted reference in every layer measured here,
    and in 63 of 63 layers of untied Gaussian weights.)"""
    rng = np.random.default_rng(0)
    shapes = shapes_of(kind)
    w = weights(shapes, rng, ties=True)
    m = masks(shapes, rng, empty="b.conv.weight" if kind == "small" else None)
    jw, jm = to_flax(w), to_flax(m)
    ref = from_flax_masks(jax.jit(JP.fake_prune, static_argnums=0)(
        ratio, jw, jm))
    got = PP.fake_prune(ratio, w, m)
    assert_masks_equal(got, ref)
    for k, v in got.items():
        assert torch.all(v <= m[k]), k
    if kind == "small":
        assert torch.equal(got["b.conv.weight"], m["b.conv.weight"])
    jit_thr = jax.jit(JP._percentile_alive, static_argnums=2)
    for k in PM.maskable_names(w):
        absw, flat = w[k].reshape(-1).abs(), m[k].reshape(-1)
        thr, n = PP.percentile_alive(absw, flat, ratio)
        ja, jf = jnp.asarray(absw.numpy()), jnp.asarray(flat.numpy())
        with jax.disable_jit():
            op_thr, op_n = JP._percentile_alive(ja, jf, ratio)
        assert int(n) == int(op_n)
        if int(n) == 0:
            continue
        assert thr.numpy().view(np.int32) == \
            np.asarray(op_thr).view(np.int32), k
        j_thr = np.asarray(jit_thr(ja, jf, ratio)[0])
        ulps = abs(int(thr.numpy().view(np.int32))
                   - int(j_thr.view(np.int32)))
        assert ulps <= 1, (k, ulps)
        if ulps:
            lo, hi = sorted((float(thr), float(j_thr)))
            assert not torch.any((absw > lo) & (absw < hi)), k


def test_mask_distance_and_density_equal():
    """``mask_distance_mean`` and ``density_all_leaves`` at the flagship
    shapes equal the jitted reference's as floats (its means multiply by
    the float32 reciprocal of the count, which the port does too; run op
    by op the reference divides, one ulp away here)."""
    rng = np.random.default_rng(1)
    shapes = shapes_of("alexnet")
    w = weights(shapes, rng)
    a, b = masks(shapes, rng, 0.6), masks(shapes, rng, 0.9)
    ja, jb, jw = to_flax(a), to_flax(b), to_flax(w)
    got_d = float(PP.mask_distance_mean(a, b))
    got_n = float(PP.density_all_leaves(w))
    assert got_d == float(jax.jit(JP.mask_distance_mean)(ja, jb))
    assert got_n == float(jax.jit(JP.density_all_leaves)(jw))
    assert float(PP.mask_distance_mean(a, a)) == 0.0


# ---------------------------------------------------------- DisPFL masks

@pytest.mark.parametrize("distribution", ["ERK", "uniform"])
@pytest.mark.parametrize("power", [1.0, 0.5])
@pytest.mark.parametrize("dense_ratio", [0.2, 0.4, 0.5, 0.6, 0.8, 1.0])
def test_calculate_sparsities_equal(distribution, power, dense_ratio):
    """Every layer's sparsity at the flagship shapes equals the
    reference's as a float (ERK's float64 sums run in its leaf order);
    at dense ratio 0.5 ERK makes the stem dense (its escape loop)."""
    shapes = shapes_of("alexnet")
    w = {k: torch.zeros(s) for k, s in shapes.items()}
    got = PM.calculate_sparsities(w, distribution, dense_ratio, power)
    ref = JM.calculate_sparsities(to_flax(w), distribution, dense_ratio,
                                  power)
    assert {flax_name(k): v for k, v in got.items()} == ref
    if distribution == "ERK" and dense_ratio == 0.5:
        assert got["f0.conv.weight"] == 0.0
        assert 0 < got["f3.conv.weight"] < 1


@pytest.mark.parametrize("dense_ratio", [0.2, 0.5, 0.9])
def test_init_masks_exact_counts(dense_ratio):
    """Exactly ``int((1 - s) * numel)`` ones in each maskable layer, as in
    the reference's draw; ones elsewhere."""
    shapes = shapes_of("alexnet")
    w = {k: torch.zeros(s) for k, s in shapes.items()}
    sp = PM.calculate_sparsities(w, "ERK", dense_ratio)
    got = PM.init_masks(torch.Generator().manual_seed(0), w, sp)
    ref = from_flax_masks(JM.init_masks(jax.random.key(0), to_flax(w),
                                        {flax_name(k): v
                                         for k, v in sp.items()}))
    for k, m in got.items():
        assert int(m.sum()) == int(ref[k].sum()), k
        if k in sp:
            assert int(m.sum()) == int((1.0 - sp[k]) * m.numel()), k
        else:
            assert torch.all(m == 1), k


@pytest.mark.parametrize("kind", ["small", "alexnet"])
@pytest.mark.parametrize("round_idx", [0, 3, 7])
def test_fire_and_regrow_bit_equal(kind, round_idx):
    """``fire_mask`` on weights with ties in |w| and ``regrow_mask`` on
    gradients with exact zeros (a third of them) and ties: the drop
    counts, the fired masks and the regrown masks equal the jitted
    reference's bit for bit (a stable rank: ties go in index order), and
    every layer keeps its nonzero count."""
    rng = np.random.default_rng(2 + round_idx)
    shapes = shapes_of(kind)
    w = weights(shapes, rng, ties=True)
    g = weights(shapes, rng, ties=True)
    for v in g.values():
        v[torch.from_numpy(rng.random(tuple(v.shape)) < 1 / 3)] = 0.0
    m = masks(shapes, rng, 0.5)
    comm_round = 10

    @jax.jit
    def ref_fn(r, jm, jw, jg):
        fired, k = JM.fire_mask(jm, jw, r, comm_round, anneal_factor=0.5)
        return fired, k, JM.regrow_mask(fired, k, jg)

    j_fired, j_k, j_grown = ref_fn(jnp.float32(round_idx), to_flax(m),
                                   to_flax(w), to_flax(g))
    fired, k = PM.fire_mask(m, w, round_idx, comm_round, anneal_factor=0.5)
    grown = PM.regrow_mask(fired, k, g)
    assert {flax_name(n): int(v) for n, v in k.items()} == \
        {n: int(v) for n, v in j_k.items()}
    assert_masks_equal(fired, from_flax_masks(j_fired))
    assert_masks_equal(grown, from_flax_masks(j_grown))
    for n in k:
        assert int(grown[n].sum()) == int(m[n].sum()), n
    assert any(int(v) > 0 for v in k.values())


def _count_masks(nnz: dict[str, int]):
    """One-entry masks whose sum is each layer's nonzero count: the drop
    count of ``fire_mask`` on them is that of a layer with ``nnz`` alive
    entries (what the count reads of a mask is its sum)."""
    port = {k: torch.full((1, 1), float(v)) for k, v in nnz.items()}
    return port, to_flax(port)


def test_drop_counts_every_round_of_200():
    """``k = ceil(drop_ratio * nnz)`` for every round of a 200-round
    schedule at the flagship layers' nonzero counts (ERK at dense ratio
    0.5): equal to the reference run op by op in all 1400 (round, layer)
    pairs. The jitted reference folds ``pi / comm_round`` into one
    constant, which moves the cosine's argument by an ulp in some rounds;
    that moves k by one in exactly two pairs, named here. (``torch.cos``
    instead of the correctly rounded cosine would move one more, round
    160 of ``f1``.)"""
    shapes = shapes_of("alexnet")
    w = {k: torch.zeros(s) for k, s in shapes.items()}
    sp = PM.calculate_sparsities(w, "ERK", 0.5)
    nnz = {k: int((1.0 - s) * w[k].numel()) for k, s in sp.items()}
    pm, jm = _count_masks(nnz)
    C = 200

    def fire_counts(r, masks_):
        return JM.fire_mask(masks_, masks_, r, C, anneal_factor=0.5)[1]

    jit_counts = jax.jit(fire_counts)
    off_by_one = []
    for r in range(C):
        got = {flax_name(k): int(v) for k, v in
               PM.fire_mask(pm, pm, r, C, anneal_factor=0.5)[1].items()}
        with jax.disable_jit():
            op = {k: int(v) for k, v in
                  fire_counts(jnp.float32(r), jm).items()}
        assert got == op, r
        jit = {k: int(v) for k, v in
               jit_counts(jnp.float32(r), jm).items()}
        for k in got:
            if got[k] != jit[k]:
                assert abs(got[k] - jit[k]) == 1
                off_by_one.append((r, k))
    assert off_by_one == [(127, "f2/conv/kernel"), (127, "f4/conv/kernel")]


def test_random_regrow_properties():
    """Under ``dis_gradient_check`` the port draws its own uniforms (torch
    cannot replay the reference's PRNG): each layer regrows exactly its
    drop count, all on entries the fired mask had dead, so its nonzero
    count is back where it was."""
    rng = np.random.default_rng(3)
    shapes = shapes_of("alexnet")
    w = weights(shapes, rng)
    m = masks(shapes, rng, 0.5)
    fired, k = PM.fire_mask(m, w, 2, 10)
    grown = PM.regrow_mask(fired, k, None,
                           generator=torch.Generator().manual_seed(0),
                           dis_gradient_check=True)
    for n in k:
        new = (grown[n] > 0) & (fired[n] == 0)
        assert int(new.sum()) == int(k[n]) > 0, n
        assert torch.all(grown[n] >= fired[n]), n
        assert int(grown[n].sum()) == int(m[n].sum()), n


def test_mask_hamming_distance_equal():
    """The count of differing entries over every leaf equals the
    reference's."""
    rng = np.random.default_rng(4)
    shapes = shapes_of("alexnet")
    a, b = masks(shapes, rng, 0.5), masks(shapes, rng, 0.5)
    got = float(PM.mask_hamming_distance(a, b))
    assert got == float(jax.jit(JM.mask_hamming_distance)(to_flax(a),
                                                          to_flax(b)))
    assert got == sum(int((a[k] != b[k]).sum()) for k in a)


# ------------------------------------------------- activity and neighbours

@pytest.mark.parametrize("seed", [0, 1024])
@pytest.mark.parametrize("prob", [1.0, 0.6, 0.2])
def test_activity_mask_bit_equal(seed, prob):
    for r in range(20):
        for n in (1, 4, 21):
            assert np.array_equal(activity_mask(seed, r, n, prob),
                                  j_activity_mask(seed, r, n, prob))


def _engines(cs: str, frac: float, active: float):
    """The reference's and the port's DisPFL engine state that the graph
    reads: 7 clients of which 6 hold data."""
    fed = dict(client_num_in_total=7, frac=frac, cs=cs, active=active)
    state = dict(num_clients=7, real_clients=6, fault_schedule=None)
    return (SimpleNamespace(cfg=JExp(seed=1024, fed=JFed(**fed)), **state),
            SimpleNamespace(cfg=ExperimentConfig(seed=1024,
                                                 fed=FedConfig(**fed)),
                            **state))


@pytest.mark.parametrize("cs", ["random", "ring", "full", "self"])
@pytest.mark.parametrize("frac,active", [(1.0, 1.0), (0.5, 1.0),
                                         (0.5, 0.5), (1.0, 0.5)])
def test_adjacency_bit_equal(cs, frac, active):
    """The activity draw and the neighbour matrix of every round equal the
    reference's bit for bit: at full and partial participation, with
    inactive clients (only themselves), the padding client alone."""
    jeng, peng = _engines(cs, frac, active)
    for r in range(12):
        act = DisPFLEngine.active_draw(peng, r)
        assert np.array_equal(act, JDisPFL.active_draw(jeng, r))
        A = DisPFLEngine.adjacency(peng, r, act)
        assert np.array_equal(A, JDisPFL.adjacency(jeng, r, act))
        assert np.all(np.diag(A) == 1) and A[6].sum() == 1
        for c in np.flatnonzero(~act[:6]):
            assert A[c].sum() == 1
