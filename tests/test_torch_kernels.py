"""The port's three kernels, held on the CPU against the reference package.

On a CPU tensor each wrapper of ``neuroimagedisttraining_tpu_torch.ops``
runs its plain PyTorch version; these tests pin that version to the JAX
reference (its Pallas kernel in interpret mode, and its XLA fallback) on
inputs made with numpy from a seed. The CUDA kernels themselves are held
against the same plain versions on the card by ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuroimagedisttraining_tpu.config import OptimConfig as JOptim
from neuroimagedisttraining_tpu.core import optim as JO
from neuroimagedisttraining_tpu.ops import fused_update as JFU
from neuroimagedisttraining_tpu.ops import snip as JSNIP
from neuroimagedisttraining_tpu.ops import stemconv as JSC
from neuroimagedisttraining_tpu.ops import topk as JTK
from neuroimagedisttraining_tpu_torch.config import OptimConfig
from neuroimagedisttraining_tpu_torch.core import optim as PO
from neuroimagedisttraining_tpu_torch.ops import _cuda
from neuroimagedisttraining_tpu_torch.ops import fused_update as PFU
from neuroimagedisttraining_tpu_torch.ops import snip as PSNIP
from neuroimagedisttraining_tpu_torch.ops import stemconv as PSC
from neuroimagedisttraining_tpu_torch.ops import topk as PTK

#: the reference's resnet18 (``models/resnet2d.py``, 10 classes): 62
#: parameter leaves, 11,173,962 parameters, in its tree order
from chip_smoke import RESNET18_SIZES


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# kernel 1: stem weight gradient
# ---------------------------------------------------------------------------

def test_stem_dw_plain_matches_reference():
    """Plain dW == the Pallas split-K kernel (interpret mode; R = 9464 spans
    one 8192 block plus the ragged tail) and the XLA kernel-grad. f32 sums
    of 9464 products in different orders: 1e-5 of the largest entry."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 29, 31, 29, 1)).astype(np.float32)
    g = rng.standard_normal((4, 13, 14, 13, 64)).astype(np.float32)
    ref = np.asarray(JSC._dw_reference(jnp.asarray(x), jnp.asarray(g)))
    pal = np.asarray(JSC._dw_pallas(jnp.asarray(x), jnp.asarray(g),
                                    interpret=True))
    before = _cuda.counts().get("stem_dw", 0)
    port = PSC.stem_dw(_t(x), _t(g)).numpy()
    assert port.shape == (5, 5, 5, 1, 64)
    tol = 1e-5 * np.abs(ref).max()
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol)
    np.testing.assert_allclose(port, pal, rtol=0, atol=tol)
    # the CPU path is the plain version: no kernel launch is counted
    assert _cuda.counts().get("stem_dw", 0) == before


def _tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: through the int32 view."""
    bits = (a.view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


@pytest.mark.parametrize("kind", ["gaussian", "integral"])
def test_stem_dw_split_tf32_matches_reference(kind):
    """The numeric design of the stem dW kernel, emulated: each operand is
    split into hi = tf32(v) and lo = tf32(v - hi) and each tap sums
    lo*hi + hi*lo + hi*hi (exact products of TF32 values; summed in float64
    here). Within 1e-5 of the largest entry of the reference on Gaussian x
    and on the slice's integral 0..255 x; a single TF32 product is not."""
    rng = np.random.default_rng(3)
    if kind == "gaussian":
        x = rng.standard_normal((4, 29, 31, 29, 1)).astype(np.float32)
    else:
        x = rng.integers(0, 256, (4, 29, 31, 29, 1)).astype(np.float32)
    g = rng.standard_normal((4, 13, 14, 13, 64)).astype(np.float32)
    ref = np.asarray(JSC._dw_reference(jnp.asarray(x), jnp.asarray(g)))
    xb, g2 = _t(x[..., 0]), _t(g).reshape(-1, 64)
    gh = _tf32_rna(g2)
    gl = _tf32_rna(g2 - gh)
    split, single = [], []
    od, oh, ow = g.shape[1:4]
    for kd in range(5):
        for kh in range(5):
            for kw in range(5):
                a = xb[:, kd:kd + 2 * od - 1:2, kh:kh + 2 * oh - 1:2,
                       kw:kw + 2 * ow - 1:2].reshape(1, -1)
                ah = _tf32_rna(a)
                al = _tf32_rna(a - ah)
                split.append(al.double() @ gh.double()
                             + ah.double() @ gl.double()
                             + ah.double() @ gh.double())
                single.append(ah.double() @ gh.double())
    split = torch.cat(split).reshape(5, 5, 5, 1, 64).numpy()
    single = torch.cat(single).reshape(5, 5, 5, 1, 64).numpy()
    tol = 1e-5 * np.abs(ref).max()
    np.testing.assert_allclose(split, ref, rtol=0, atol=tol)
    assert np.abs(single - ref).max() > tol  # why the split is needed
    if kind == "integral":  # x's low part is exactly zero there
        assert not _tf32_rna(xb - _tf32_rna(xb)).any()


def test_stem_conv3d_grads_match_reference():
    """The autograd Function's (y, dx, dW) == the reference's custom VJP
    (its CPU path is XLA autodiff), layouts converted; 1e-5 of the
    largest entry (f32 sums in different orders)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 13, 15, 13, 1)).astype(np.float32)
    w = rng.standard_normal((5, 5, 5, 1, 8)).astype(np.float32)

    def loss(x_, w_):
        return jnp.sum(JSC.stem_conv3d(x_, w_) ** 2)

    y_ref = np.asarray(JSC.stem_conv3d(jnp.asarray(x), jnp.asarray(w)))
    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = _t(x[..., 0])[:, None].requires_grad_(True)        # NCDHW
    wt = _t(np.transpose(w, (4, 3, 0, 1, 2))).requires_grad_(True)  # OIDHW
    y = PSC.stem_conv3d(xt, wt)
    (y ** 2).sum().backward()
    for port, ref in (
            (y.detach().permute(0, 2, 3, 4, 1).numpy(), y_ref),
            (xt.grad[:, 0].numpy(), np.asarray(gx)[..., 0]),
            (wt.grad.permute(2, 3, 4, 1, 0).numpy(), np.asarray(gw))):
        np.testing.assert_allclose(port, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_stem_dw_takes_the_ncdhw_view():
    """g as the convolution's backward hands it over (the channels-last
    view of NCDHW memory, the layout the kernel reads) gives the same dW
    as a contiguous channels-last g: bit-equal, the same products."""
    rng = np.random.default_rng(9)
    x = _t(rng.standard_normal((2, 17, 19, 17, 1)).astype(np.float32))
    g_ncdhw = _t(rng.standard_normal((2, 64, 7, 8, 7)).astype(np.float32))
    view = g_ncdhw.permute(0, 2, 3, 4, 1)
    assert not view.is_contiguous()
    np.testing.assert_array_equal(PSC.stem_dw(x, view).numpy(),
                                  PSC.stem_dw(x, view.contiguous()).numpy())


def test_stem_dw_refuses_other_devices():
    """A tensor neither on the CPU nor on a CUDA device is refused, never
    routed to the plain path."""
    x = torch.zeros(1, 13, 13, 13, 1)
    g = torch.zeros(1, 5, 5, 5, 64)
    assert PSC.stem_dw(x, g).shape == (5, 5, 5, 1, 64)
    with pytest.raises(ValueError):
        PSC.stem_dw(x.to("meta"), g.to("meta"))


# ---------------------------------------------------------------------------
# kernel 2: fused SGD tail
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip,wd,mom,masked", [
    (10.0, 5e-4, 0.9, True),
    (1e-3, 0.0, 0.0, False),
])
def test_fused_sgd_step_matches_reference(clip, wd, mom, masked):
    """The port's fused step (plain path on the CPU) == the reference's
    XLA fallback and its Pallas kernel in interpret mode, on a lane-
    unaligned leaf. rtol 1e-6 / atol 1e-7: XLA's CPU fusion contracts a
    multiply and an add into one FMA where the port rounds each."""
    rng = np.random.default_rng(7)
    shapes = {"b": (5,), "w": (13, 57)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: (v * 0.3 + 0.1).astype(np.float32) for k, v in p.items()}
    t = {k: np.ones_like(v) for k, v in p.items()} if mom > 0 else None
    m = ({k: (v > 0).astype(np.float32) for k, v in p.items()}
         if masked else None)
    lr = np.float32(0.05)
    jt = (lambda d: None if d is None else
          {k: jnp.asarray(v) for k, v in d.items()})
    kw = dict(clip=clip, wd=wd, momentum=mom, lr=jnp.float32(lr))
    refs = [JFU.fused_sgd_step(jt(p), jt(g), jt(t), jt(m), use_pallas=False,
                               **kw),
            JFU.fused_sgd_step(jt(p), jt(g), jt(t), jt(m), use_pallas=False,
                               interpret=True, **kw)]
    names = sorted(shapes)
    pp = [_t(p[k]).clone() for k in names]
    tp = [_t(t[k]).clone() for k in names] if t is not None else None
    mp = [_t(m[k]) for k in names] if m is not None else None
    PFU.fused_sgd_step(pp, [_t(g[k]) for k in names], tp, mp, clip=clip,
                       wd=wd, momentum=mom, lr=torch.tensor(lr))
    for rp, rt in refs:
        for i, k in enumerate(names):
            np.testing.assert_allclose(pp[i].numpy(), np.asarray(rp[k]),
                                       rtol=1e-6, atol=1e-7)
            if mom > 0:
                np.testing.assert_allclose(tp[i].numpy(), np.asarray(rt[k]),
                                           rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("clip", [0.0, 1e-3, 1e6])
def test_fused_sgd_apply_matches_step(clip):
    """The step is the device scalars ``[ok, gnorm, lr]`` and then the
    per-leaf pass: bit-equal to the plain step, whether the clip stage is
    off, taken or skipped."""
    rng = np.random.default_rng(13)
    shapes = [(6, 5), (11,)]
    p = [_t(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    g = [_t(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    t = [_t(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    m = [(a > 0).to(torch.float32) for a in p]
    lr = torch.tensor(np.float32(0.05))
    kw = dict(clip=clip, wd=5e-4, momentum=0.9)
    scal = PFU.sgd_scalars(g, clip=clip, lr=lr)
    assert scal.dtype == torch.float32 and scal.shape == (3,)
    if clip > 0:
        gnorm = PFU.global_norm(g)
        assert float(scal[0]) == float(gnorm < clip)
        assert float(scal[1]) == float(gnorm)
    assert float(scal[2]) == float(lr)
    pa, ta = [a.clone() for a in p], [a.clone() for a in t]
    PFU.fused_sgd_apply(pa, g, ta, m, scal, **kw)
    ps, ts = [a.clone() for a in p], [a.clone() for a in t]
    PFU.sgd_step_plain(ps, g, ts, m, lr=lr, **kw)
    for a, b in zip(pa + ta, ps + ts):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("fused", [False, True])
def test_local_optimizer_matches_optax_chain(fused):
    """Three steps of the port's SGD (plain chain, or the fused path) ==
    the reference's optax chain at unit lr scaled by lr after momentum.
    Same tolerance and reason as the fused-step test."""
    rng = np.random.default_rng(11)
    p = {"a": rng.standard_normal((7, 9)).astype(np.float32),
         "b": rng.standard_normal((3,)).astype(np.float32)}
    cfg = dict(lr=0.05, grad_clip=1.0, wd=5e-4, momentum=0.9)
    jopt = JO.make_local_optimizer(JOptim(**cfg))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = jopt.init(jp)
    popt = PO.LocalOptimizer(OptimConfig(fused_update=fused, **cfg))
    names = sorted(p)
    pp = [_t(p[k]).clone() for k in names]
    tr = popt.init(pp)
    for step in range(3):
        g = {k: (rng.standard_normal(v.shape) * (step + 1)).astype(np.float32)
             for k, v in p.items()}
        upd, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                              jp, jnp.float32(0.05))
        jp = jax.tree.map(jnp.add, jp, upd)
        popt.step(pp, [_t(g[k]) for k in names], tr,
                  torch.tensor(np.float32(0.05)))
    for i, k in enumerate(names):
        np.testing.assert_allclose(pp[i].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


def test_round_lr_bit_equal():
    """lr * lr_decay**round: float32 integer power by repeated squaring,
    bit-equal to the reference across the 200-round schedule."""
    cfg = OptimConfig()
    rounds = [0, 1, 2, 3, 5, 7, 8, 31, 64, 100, 127, 199]
    ref = np.asarray([JO.round_lr(JOptim(), r) for r in rounds])
    port = np.asarray([PO.round_lr(cfg, r, torch.device("cpu")).numpy()
                       for r in rounds])
    np.testing.assert_array_equal(port.view(np.int32), ref.view(np.int32))


def test_global_norm_matches_optax():
    rng = np.random.default_rng(2)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((4, 5), (7,), (3, 3, 3))]
    ref = float(optax.global_norm([jnp.asarray(a) for a in leaves]))
    port = float(PFU.global_norm([_t(a) for a in leaves]))
    assert port == pytest.approx(ref, rel=1e-6)


def _flagship_sizes():
    from neuroimagedisttraining_tpu_torch.models import create_model
    return [p.numel() for p in
            create_model("3dcnn", (121, 145, 121)).parameters()]


_PLAN_CASES = {
    "flagship": _flagship_sizes,
    # n = 1, n % 4 != 0, one element past a chunk, exact chunks, empty
    "ragged": lambda: [1, 4097, 3, 8191, 5, 4096, 7, 0, 12289, 2],
    "one_large_many_small": lambda: [3 * 4096 * 97 + 3] + list(range(1, 32)),
    # the most leaves one table holds
    "many_leaves": lambda: [int(n) for n in np.random.default_rng(5)
                            .integers(0, 20_000, 32)],
    # two tables, the second ragged
    "resnet18": lambda: RESNET18_SIZES,
    # five tables, empty leaves at a table's start and end
    "many_tables": lambda: [0] + [int(n) for n in np.random.default_rng(6)
                                  .integers(0, 9_000, 140)] + [0],
}


@pytest.mark.parametrize("case", sorted(_PLAN_CASES))
def test_plan_chunks_covers_every_element(case):
    """The planner's chunks, looked up as the kernels look them up (within
    a table, the last leaf whose first chunk <= c), cover every element of
    every leaf exactly once; no chunk straddles two leaves; the tables
    are ``MAX_LEAVES`` consecutive leaves each (the last ragged), cover
    the chunks in order, and each fits the kernel-parameter budget."""
    sizes = _PLAN_CASES[case]()
    plan = PFU.plan_chunks(sizes)
    assert len(plan.first) == len(sizes)
    assert len(plan.tables) == -(-len(sizes) // PFU.MAX_LEAVES)
    if case == "flagship":
        assert len(sizes) == 24 and sum(sizes) == 2_570_241
        assert plan.nchunks == 645 and len(plan.tables) == 1
    if case == "resnet18":
        assert len(sizes) == 62 and sum(sizes) == 11_173_962
        assert [t[:2] for t in plan.tables] == [(0, 32), (32, 62)]
    cover = [np.zeros(n, np.int32) for n in sizes]
    end = 0
    for l0, l1, c0, c1 in plan.tables:
        assert (l0, c0) == (end if l0 else 0, plan.first[l0] if l0 else 0)
        assert 0 < l1 - l0 <= PFU.MAX_LEAVES and c0 <= c1
        end = l1
        first = [f - c0 for f in plan.first[l0:l1]]
        for c in range(c1 - c0):
            i = l0 + PFU.chunk_leaf(first, c)
            off = (c - first[i - l0]) * PFU.CHUNK
            assert 0 <= off < sizes[i]  # the chunk lies inside one leaf
            cover[i][off:off + PFU.CHUNK] += 1
    assert end == len(sizes) and plan.tables[-1][3] == plan.nchunks
    for i, cv in enumerate(cover):
        assert (cv == 1).all(), (i, sizes[i])
    assert PFU.TABLE_BYTES <= PFU.TABLE_BUDGET


def test_plan_chunks_refuses_what_no_table_holds():
    """A negative leaf size is refused; any number of leaves is cut into
    tables of at most 32, each within the kernel-parameter budget (the
    planner never hands the kernels a table they cannot take, and nothing
    falls back to the plain chain)."""
    assert PFU.TABLE_BYTES == 32 * 48 + 8
    with pytest.raises(ValueError):
        PFU.plan_chunks([5, -1])
    assert PFU.plan_chunks([5] * 32).tables == ((0, 32, 0, 32),)
    assert PFU.plan_chunks([5] * 33).tables == ((0, 32, 0, 32),
                                                (32, 33, 32, 33))


@functools.lru_cache(maxsize=None)
def _norm_case(which: str):
    """Leaves and ``optax.global_norm`` of them, drawn and computed once a
    module for every block count: ``"table"`` 32 ragged leaves (a full
    table), ``"resnet18"`` resnet18's 62 leaves (two tables),
    ``"ragged140"`` 140 ragged leaves (five tables)."""
    rng = np.random.default_rng({"table": 0, "resnet18": 100,
                                 "ragged140": 101}[which])
    if which == "table":
        sizes = [int(n) for n in rng.integers(1, 30_000, 31)] + [70_001]
    elif which == "resnet18":
        sizes = RESNET18_SIZES
    else:
        sizes = [int(n) for n in rng.integers(0, 9_000, 140)]
    leaves = [(rng.standard_normal(n) * rng.choice([1e-3, 1.0, 30.0])
               ).astype(np.float32) for n in sizes]
    return leaves, float(optax.global_norm([jnp.asarray(a) for a in leaves]))


@pytest.mark.parametrize("nblocks", [1, 7, 1056])
def test_global_norm_blocked_matches_optax(nblocks):
    """The kernel's blocked fp64 norm (chunks dealt to blocks, fp64
    partials, one rounding of the sqrt), over 32 ragged leaves (a full
    table), == ``optax.global_norm`` within rtol 2e-6."""
    leaves, ref = _norm_case("table")
    port = PFU.global_norm_blocked([_t(a) for a in leaves], nblocks)
    assert port.dtype == torch.float32
    assert float(port) == pytest.approx(ref, rel=2e-6)


@pytest.mark.parametrize("nblocks", [1, 7, 1056])
def test_global_norm_blocked_over_tables_matches_optax(nblocks):
    """The same over resnet18's 62 leaves (two tables, each launch's blocks
    writing their partials into one buffer) and over 140 ragged leaves
    (five tables): within rtol 2e-6 of ``optax.global_norm``."""
    for which in ("resnet18", "ragged140"):
        leaves, ref = _norm_case(which)
        port = PFU.global_norm_blocked([_t(a) for a in leaves], nblocks)
        assert float(port) == pytest.approx(ref, rel=2e-6)


@pytest.mark.parametrize("entry", ["step", "apply"])
def test_fused_sgd_refuses_other_devices(entry, monkeypatch):
    """Leaves neither on the CPU nor on a CUDA device are refused by both
    entry points, never routed to the plain chain."""
    def plain(*a, **k):
        raise AssertionError("routed to the plain chain")
    monkeypatch.setattr(PFU, "sgd_apply_plain", plain)
    monkeypatch.setattr(PFU, "sgd_scalars", plain)
    leaves = [torch.zeros(3, 5, device="meta"), torch.zeros(7, device="meta")]
    kw = dict(clip=1.0, wd=5e-4, momentum=0.9)
    with pytest.raises(ValueError, match="unsupported device"):
        if entry == "step":
            PFU.fused_sgd_step(leaves, leaves, leaves, None, lr=0.1, **kw)
        else:
            PFU.fused_sgd_apply(leaves, leaves, leaves, None,
                                torch.zeros(3, device="meta"), **kw)


def test_fused_sgd_host_table():
    """The host table the kernels read: one row of int64 words a leaf (p,
    g, momentum, mask pointers, size, first chunk), kept while the caller
    steps the same params, momentum and mask, with only the grad column
    rewritten; each grad is checked for dtype, contiguity and shape."""
    rng = np.random.default_rng(21)
    shapes = [(5, 3), (1,), (4099,), (2, 4096)]
    p = [_t(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    t = [torch.zeros_like(a) for a in p]
    m = [torch.ones_like(a) for a in p]
    g = [torch.ones_like(a) for a in p]
    dev = torch.device("cpu")
    tab = PFU._Table(p, t, m, dev)
    tab.set_grads(g)
    want = [[a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
             a.numel(), f] for a, b, c, d, f in
            zip(p, g, t, m, PFU.plan_chunks([a.numel() for a in p]).first)]
    np.testing.assert_array_equal(tab.rows, np.asarray(want, np.int64))
    assert tab.nchunks == 1 + 1 + 2 + 2
    assert tab.holds(p, t, m) and not tab.holds(p, t, None)
    assert not tab.holds([p[0].clone(), *p[1:]], t, m)
    g2 = [torch.ones_like(a) for a in p]
    tab.set_grads(g2)
    assert list(tab.rows[:, 1]) == [a.data_ptr() for a in g2]
    no_trace = PFU._Table(p, None, m, dev)
    assert (no_trace.rows[:, 2] == 0).all() and (no_trace.rows[:, 3] != 0).all()
    for bad in (g[2].double(), torch.ones(4099, 2)[:, 0], torch.ones(4100)):
        with pytest.raises(ValueError):
            tab.set_grads([g[0], g[1], bad, g[3]])


@pytest.mark.parametrize("clip", [0.0, 1e-3])
def test_fused_sgd_step_returns_its_scalars(clip):
    """With a clip the step returns its ``[ok, gnorm, lr]`` (the plain
    scalars on the CPU); without one, None."""
    rng = np.random.default_rng(17)
    p = [_t(rng.standard_normal(s).astype(np.float32)) for s in ((6, 5), (3,))]
    g = [a * 0.5 for a in p]
    lr = torch.tensor(np.float32(0.05))
    scal = PFU.fused_sgd_step(p, g, None, None, clip=clip, wd=0.0,
                              momentum=0.0, lr=lr)
    if clip == 0:
        assert scal is None
    else:
        np.testing.assert_array_equal(
            scal.numpy(), PFU.sgd_scalars(g, clip=clip, lr=lr).numpy())


# ---------------------------------------------------------------------------
# kernel 3: count >= thresholds and the top-k threshold
# ---------------------------------------------------------------------------

def _scores(kind: str, n: int, rng) -> np.ndarray:
    if kind == "normal":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "saliency":  # heavy-tailed, normalized like SNIP scores
        x = np.abs(rng.standard_normal(n)).astype(np.float32) ** 3
        return (x / x.sum()).astype(np.float32)
    if kind == "tail":  # lognormal, sigma 4: ladders stop above float resolution
        return rng.lognormal(0.0, 4.0, n).astype(np.float32)
    return rng.integers(0, 50, n).astype(np.float32)  # many ties


def test_linspace_ladder_bit_equal():
    """The port's ladder == ``jnp.linspace`` run op by op (the reference's
    formula: ``start * (1 - i/(n-1)) + stop * i/(n-1)``, stop appended),
    bit for bit, on brackets from wide to a few ulps."""
    rng = np.random.default_rng(0)
    for t in range(60):
        lo, hi = np.sort(rng.standard_normal(2).astype(np.float32)
                         * rng.choice([1e-6, 1e-3, 1.0, 1e3])
                         ).astype(np.float32)
        if t % 3 == 0:
            hi = np.float32(lo + np.float32(1e-6) * abs(lo))
        with jax.disable_jit():
            ref = np.asarray(jnp.linspace(jnp.float32(lo), jnp.float32(hi),
                                          512))
        port = PTK.linspace(torch.tensor(lo, dtype=torch.float32),
                             torch.tensor(hi, dtype=torch.float32), 512).numpy()
        np.testing.assert_array_equal(port.view(np.int32),
                                      ref.view(np.int32))


@pytest.mark.parametrize("kind", ["normal", "saliency", "ties"])
def test_count_ge_exact(kind):
    """Counts over a 512-threshold ladder == the reference's XLA counting
    pass, exactly (integer counts below 2^24)."""
    rng = np.random.default_rng(1)
    x = _scores(kind, 40_000, rng)
    thr = np.linspace(x.min(), x.max(), 512).astype(np.float32)
    ref = np.asarray(JTK._count_ge_xla(JTK._pad_to_blocks(jnp.asarray(x)),
                                       jnp.asarray(thr)))
    port = PTK.count_ge(_t(x), _t(thr)).numpy()
    np.testing.assert_array_equal(port, ref)


def test_count_ge_unsorted_ladder_with_nonfinite_values():
    """The kernel sorts its ladder; its plain version must count any ladder
    exactly as ``x >= thr`` does: unsorted, with ties, NaN (counts nothing)
    and +-inf thresholds, over scores holding NaN (never counted), +-inf
    and signed zeros."""
    rng = np.random.default_rng(6)
    special = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0], np.float32)
    for _ in range(20):
        x = rng.integers(-5, 5, int(rng.integers(1, 400))).astype(np.float32)
        hit = rng.random(x.size) < 0.2
        x[hit] = rng.choice(special, hit.sum())
        thr = rng.integers(-6, 6, int(rng.integers(1, 60))).astype(np.float32)
        hit = rng.random(thr.size) < 0.3
        thr[hit] = rng.choice(special, hit.sum())
        with np.errstate(invalid="ignore"):
            ref = (x[:, None] >= thr[None, :]).sum(0).astype(np.float32)
        np.testing.assert_array_equal(PTK.count_ge(_t(x), _t(thr)).numpy(),
                                      ref)


@pytest.mark.parametrize("kind", ["normal", "saliency", "ties", "tail"])
def test_kth_largest_bit_equal(kind):
    """The threshold is bit-equal to the reference's ``kth_largest``
    (XLA counting path) run op by op, over sizes and ranks. Against the
    JIT-compiled reference, whose CPU code contracts the ladder's
    multiply-adds into FMAs (a ladder value may move by one ulp where the
    bracket has not reached float resolution), the masks ``x >= thr`` are
    identical. ``tail``: lognormal scores with the k-th value near the
    bottom (k ~ 0.95 n), where 4 x 512 bins do not reach float resolution:
    the bracket is the reference's, not the true k-th value, and the JIT's
    one-ulp ladder moves may show in the mask, so only the op-by-op result
    is held there."""
    rng = np.random.default_rng(
        {"normal": 0, "saliency": 1, "ties": 2, "tail": 3}[kind])
    for _ in range(4):
        n = int(rng.integers(100, 50_000))
        k = (int(0.95 * n) + int(rng.integers(-3, 4)) if kind == "tail"
             else int(rng.integers(1, n)))
        x = _scores(kind, n, rng)
        with jax.disable_jit():
            ref = np.asarray(JTK.kth_largest(jnp.asarray(x), k,
                                             use_pallas=False))
        port = PTK.kth_largest(_t(x), k).numpy()
        assert port.view(np.int32) == ref.view(np.int32), (n, k, port, ref)
        if kind == "tail":
            continue
        ref_jit = np.asarray(JTK.kth_largest(jnp.asarray(x), k,
                                             use_pallas=False))
        np.testing.assert_array_equal(x >= port, x >= ref_jit)


def _reference_bracket(thr, counts, k, hi):
    """The reference's ``round_fn`` bracket update (``ops/topk.py``), on
    one round's ladder and counts."""
    nbins = thr.shape[0]
    prefix = jnp.cumprod((counts >= k).astype(jnp.int32))
    j = jnp.maximum(jnp.sum(prefix) - 1, 0)
    return thr[j], jnp.where(j + 1 < nbins,
                             thr[jnp.minimum(j + 1, nbins - 1)], hi)


@pytest.mark.parametrize("case", ["wiggle", "none_reach_k", "all_reach_k",
                                  "first_only", "late_rise", "random"])
def test_select_bracket_matches_reference(case):
    """The plain bracket update (the kernel's last-block epilogue has the
    same rule) == the reference's on crafted counts that do not fall
    monotonically: the longest prefix of counts >= k, not their number."""
    rng = np.random.default_rng(8)
    nbins, k = 16, 10
    thr = np.sort(rng.standard_normal(nbins)).astype(np.float32)
    hi = np.float32(thr[-1] + 1)
    counts = {
        "wiggle": [30, 25, 20, 12, 9, 11, 10, 3, 0, 0, 0, 0, 0, 0, 0, 0],
        "none_reach_k": [9] * nbins,
        "all_reach_k": [40] * nbins,
        "first_only": [10, 9] + [0] * (nbins - 2),
        "late_rise": [5] + [20] * (nbins - 1),
        "random": list(rng.integers(0, 20, nbins)),
    }[case]
    counts = np.asarray(counts, np.float32)
    rlo, rhi = _reference_bracket(jnp.asarray(thr), jnp.asarray(counts), k,
                                  jnp.float32(hi))
    plo, phi = PTK.select_bracket(_t(thr), _t(counts), k, torch.tensor(hi))
    assert float(plo) == float(rlo) and float(phi) == float(rhi)


def test_kth_largest_refuses_other_devices():
    """Neither on the CPU (plain loop) nor on a CUDA device (the kernels):
    refused, never routed to the plain loop."""
    x = torch.arange(16, dtype=torch.float32)
    before = _cuda.counts()
    assert float(PTK.kth_largest(x, 4)) == 12.0
    # the plain loop launches nothing: neither the select nor the count
    assert _cuda.counts() == before and "kth_select" in before
    with pytest.raises(ValueError):
        PTK.kth_largest(x.to("meta"), 4)


def test_kth_largest_nonfinite_is_nan():
    x = np.arange(1000, dtype=np.float32)
    x[17] = np.nan
    assert np.isnan(float(PTK.kth_largest(_t(x), 10)))
    mask, thr = PTK.topk_threshold_mask(_t(np.arange(10, dtype=np.float32)),
                                        3)
    assert float(thr) == 7.0 and int(mask.sum()) == 3


def test_mask_from_scores_matches_reference():
    """Global mask from a score tree == the reference's on the same scores
    (thresholds bit-equal is not required: the score sum runs in another
    order; the masks must agree)."""
    rng = np.random.default_rng(4)
    jscores = {"c": {"kernel": np.abs(rng.standard_normal((3, 3, 3, 2, 4))
                                      ).astype(np.float32),
                     "bias": np.zeros(4, np.float32)},
               "d": {"kernel": np.abs(rng.standard_normal((8, 5))
                                      ).astype(np.float32)}}
    jmasks, _ = JSNIP.mask_from_scores(
        jax.tree.map(jnp.asarray, jscores), keep_ratio=0.3)
    from neuroimagedisttraining_tpu_torch.weights import masks_from_flax
    pscores = masks_from_flax(jscores)
    pmasks, _ = PSNIP.mask_from_scores(pscores, keep_ratio=0.3)
    ref = masks_from_flax(jax.tree.map(np.asarray, jmasks))
    for k in ref:
        np.testing.assert_array_equal(pmasks[k].numpy(), ref[k].numpy())


@pytest.mark.parametrize("poison", ["nan", "zero"])
def test_mask_from_scores_fails_loudly(poison):
    s = {"a.weight": torch.ones(4, 4), "a.bias": torch.zeros(4)}
    if poison == "nan":
        s["a.weight"][1, 2] = float("nan")
    else:
        s["a.weight"].zero_()
    with pytest.raises(FloatingPointError):
        PSNIP.mask_from_scores(s, keep_ratio=0.5)
