"""The port's MPC toolkit (``ops/mpc.py``) and secure quantized aggregation's
host protocol (``privacy/secure_quant.py``) against the reference
package's, bit for bit from equal ``np.random.default_rng`` seeds: the
modular arithmetic, BGW and LCC shares, the key agreement, the float32
field embeddings (also against the port's ``quantize_device`` on CPU
tensors), the frames and their msgpack bytes, the slot accumulator's fold,
merge, export and finalize, the integer weights, the headroom check and
the leaf scales, and every refusal with the reference's message. Host
numpy only: nothing here jits a JAX function."""

import re

import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.ops import mpc as jmpc
from neuroimagedisttraining_tpu.privacy import secure_quant as JSQ
from neuroimagedisttraining_tpu_torch.ops import mpc, mpc_device
from neuroimagedisttraining_tpu_torch.privacy import secure_quant as SQ

SPECS = [(8, 3), (16, 10), (32, 10), (32, 16)]
P = jmpc.P_DEFAULT


def _eq(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------- toolkit

def test_field_primes_and_wire_dtypes():
    assert mpc.FIELD_PRIMES == jmpc.FIELD_PRIMES
    for p in (2, 251, 256, 257, 65521, 65536, 65537, P, 2**32 - 5):
        assert mpc.wire_dtype_for(p) == jmpc.wire_dtype_for(p)
    with pytest.raises(ValueError, match="exceeds the uint32 wire width"):
        mpc.wire_dtype_for(2**32 + 15)


@pytest.mark.parametrize("p", [251, 65521, P])
def test_mod_pow_and_inverse(p):
    rng = np.random.default_rng(p % 97)
    a = rng.integers(1, p, size=64, dtype=np.int64)
    for e in (0, 1, 2, 17, p - 2, p - 1):
        _eq(mpc.mod_pow(a, e, p), jmpc.mod_pow(a, e, p))
    inv = mpc.mod_inv(a, p)
    _eq(inv, jmpc.mod_inv(a, p))
    assert np.all((a * inv) % p == 1)
    assert np.all(mpc.mod_pow(a, p - 1, p) == 1)  # Fermat


@pytest.mark.parametrize("p", [251, 65521, P])
def test_lagrange_coeffs_reproduce_a_polynomial(p):
    alphas = np.arange(10, 16, dtype=np.int64)
    betas = np.asarray([1, 2, 4, 7], np.int64)
    U = mpc.lagrange_coeffs(alphas, betas, p)
    _eq(U, jmpc.lagrange_coeffs(alphas, betas, p))
    coef = np.asarray([3, 5, 7, 11], np.int64)  # degree 3 through 4 points

    def poly(x):
        return sum(c * mpc.mod_pow(x, i, p) for i, c in enumerate(coef)) % p

    np.testing.assert_array_equal((U @ poly(betas)) % p, poly(alphas))


@pytest.mark.parametrize("N,T", [(5, 1), (7, 3), (4, 0)])
def test_bgw_roundtrip_and_secrecy_threshold(N, T):
    X = np.random.default_rng(1).integers(0, P, size=(6, 3), dtype=np.int64)
    shares = mpc.bgw_encode(X, N, T, rng=np.random.default_rng(2))
    _eq(shares, jmpc.bgw_encode(X, N, T, rng=np.random.default_rng(2)))
    idx = np.arange(N)[::-1][:T + 1]
    rec = mpc.bgw_decode(shares[idx], idx)
    _eq(rec, jmpc.bgw_decode(shares[idx], idx))
    np.testing.assert_array_equal(rec, X)
    if T:
        # T shares interpolate to something else than the secret
        bad = mpc.bgw_decode(shares[idx[:T]], idx[:T])
        assert not np.array_equal(bad, X)


@pytest.mark.parametrize("N,K,T", [(6, 2, 1), (8, 3, 2), (5, 4, 0)])
def test_lcc_roundtrip_on_disjoint_grids(N, K, T):
    alphas, betas = mpc._lcc_points(N, K, T, P)
    ja, jb = jmpc._lcc_points(N, K, T, P)
    _eq(alphas, ja)
    _eq(betas, jb)
    assert not set(alphas.tolist()) & set(betas.tolist())
    X = np.random.default_rng(3).integers(0, P, size=(K * 4, 2),
                                          dtype=np.int64)
    enc = mpc.lcc_encode(X, N, K, T, rng=np.random.default_rng(4))
    _eq(enc, jmpc.lcc_encode(X, N, K, T, rng=np.random.default_rng(4)))
    idx = np.arange(N)[-(K + T):]
    dec = mpc.lcc_decode(enc[idx], N, K, T, idx)
    _eq(dec, jmpc.lcc_decode(enc[idx], N, K, T, idx))
    np.testing.assert_array_equal(dec, X)
    # no worker's evaluation is a data chunk in the clear
    chunks = X.reshape(K, 4, 2)
    for e in enc:
        assert not any(np.array_equal(e, c) for c in chunks)


@pytest.mark.parametrize("g", [0, 3, 7])
def test_key_agreement_symmetric(g):
    a, b = 123456, 987654
    assert mpc.pk_gen(a, g=g) == jmpc.pk_gen(a, g=g)
    k_ab = mpc.key_agreement(a, mpc.pk_gen(b, g=g), g=g)
    assert k_ab == mpc.key_agreement(b, mpc.pk_gen(a, g=g), g=g)
    assert k_ab == jmpc.key_agreement(a, jmpc.pk_gen(b, g=g), g=g)
    if g == 0:
        assert mpc.pk_gen(a) == a  # the test mode returns the secret


def _edge_values(p: int, frac_bits: int) -> np.ndarray:
    edge = (p - 1) // 2 / float(1 << frac_bits)
    rng = np.random.default_rng(p % 1000 + frac_bits)
    return np.concatenate([
        (rng.standard_normal(256) * 0.5).astype(np.float32),
        (rng.standard_normal(64) * edge).astype(np.float32),
        np.asarray([edge, -edge, edge * 0.999, -edge * 0.999, edge * 2,
                    -edge * 2, 1e9, -1e9, 0.0, -0.0, np.nan, np.inf,
                    -np.inf, 0.5 / (1 << frac_bits),
                    -0.5 / (1 << frac_bits), 1.5 / (1 << frac_bits)],
                   np.float32)])


@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("frac_bits", [8, 10, 16])
def test_quantize32_host_device_and_reference(bits, frac_bits):
    """The float32 embedding over every field and frac_bits, NaN, +/-inf
    and the field edge: the port's host function, the reference's and the
    port's device function (on a CPU tensor) give the same residues, and
    the centred lifts the same float32 bits."""
    p = mpc.FIELD_PRIMES[bits]
    xs = _edge_values(p, frac_bits)
    host = mpc.quantize32(xs, p=p, frac_bits=frac_bits)
    _eq(host, jmpc.quantize32(xs, p=p, frac_bits=frac_bits))
    dev = mpc_device.quantize_device(torch.from_numpy(xs), p=p,
                                     frac_bits=frac_bits).numpy()
    _eq(host, dev)
    assert ((0 <= host) & (host < p)).all()
    assert host[np.isnan(xs)].tolist() == [0]
    back = mpc.dequantize32(host, p=p, frac_bits=frac_bits)
    _eq(back, jmpc.dequantize32(host, p=p, frac_bits=frac_bits))
    _eq(back, mpc_device.dequantize_device(torch.from_numpy(host), p=p,
                                           frac_bits=frac_bits).numpy())
    # +/-inf and the far overflow saturate at the field edge, sign kept
    lim = float(mpc_device._field_edge(p))
    assert lim <= (p - 1) // 2
    for v, sign in ((np.inf, 1), (-np.inf, -1), (1e9, 1), (-1e9, -1)):
        i = int(np.flatnonzero(xs == np.float32(v))[0])
        assert back[i] == np.float32(sign * lim) / np.float32(
            1 << frac_bits)


@pytest.mark.parametrize("p", [251, 65521, P])
def test_field_edge_is_the_largest_float32_in_the_field(p):
    lim = mpc_device._field_edge(p)
    assert lim <= (p - 1) // 2
    assert float(np.nextafter(np.float32(lim), np.float32(np.inf))) \
        > (p - 1) // 2


# ------------------------------------------------------- the host protocol

def _tree(seed: int, bn: float = 40.0) -> dict:
    rng = np.random.default_rng(seed)
    return {"params": {"k": (0.5 * rng.standard_normal((3, 4))).astype(
                np.float32),
                       "b": (0.5 * rng.standard_normal(7)).astype(
                           np.float32)},
            "batch_stats": {"m": (bn * rng.standard_normal(6)).astype(
                np.float32)}}


def _flat(tree: dict) -> dict:
    """The same leaves keyed by their "/"-joined paths (the port engines'
    form), in the reference's leaf order."""
    return dict(JSQ._named_leaves(tree))


def _specs(bits: int, frac_bits: int):
    return (SQ.QuantSpec.from_bits(bits, frac_bits),
            JSQ.QuantSpec.from_bits(bits, frac_bits))


@pytest.mark.parametrize("bits,frac_bits", SPECS)
@pytest.mark.parametrize("flat", [False, True], ids=["nested", "flat"])
def test_frames_equal_reference_with_their_bytes(bits, frac_bits, flat):
    """A client's frame, array for array and byte for byte once the
    envelope serializes it (the port's msgpack against flax's), from a
    nested tree or its flat named form, with and without leaf scales."""
    from flax import serialization

    from neuroimagedisttraining_tpu_torch.codec import wire

    spec, jspec = _specs(bits, frac_bits)
    tree = _tree(0)
    for scaled in (False, True):
        scales = SQ.leaf_scales(tree) if scaled else None
        got = SQ.encode_secure_quant(_flat(tree) if flat else tree, 0.25,
                                     spec, np.random.default_rng(11),
                                     scales=scales)
        want = JSQ.encode_secure_quant(
            tree, 0.25, jspec, np.random.default_rng(11),
            scales=JSQ.leaf_scales(tree) if scaled else None)
        assert list(got) == list(want)
        for key in (SQ.SECURE_QUANT_KEY, "p", "fb", "k"):
            assert got[key] == want[key] and type(got[key]) is int
        _eq(got["seeds"], want["seeds"])
        assert list(got["leaves"]) == list(want["leaves"])
        for name, rec in want["leaves"].items():
            assert got["leaves"][name]["sh"] == rec["sh"]
            assert got["leaves"][name]["dt"] == rec["dt"]
            _eq(got["leaves"][name]["v"], rec["v"])
            assert rec["v"].dtype == mpc.wire_dtype_for(spec.p)
        assert SQ.frame_nbytes(got) == JSQ.frame_nbytes(want)
        assert wire.msgpack_dumps(got) == serialization.msgpack_serialize(
            want)


@pytest.mark.parametrize("bits", [16, 32])
def test_frame_bytes_a_parameter(bits):
    """A frame of a large leaf ships ``wire_dtype_for(p)`` bytes a
    parameter plus a fixed overhead (the seeds and records)."""
    spec, jspec = _specs(bits, 10)
    n = 1 << 14
    tree = {"w": np.random.default_rng(0).standard_normal(n)
            .astype(np.float32)}
    got = SQ.frame_nbytes(SQ.encode_secure_quant(
        tree, 0.5, spec, np.random.default_rng(1)))
    assert got == JSQ.frame_nbytes(JSQ.encode_secure_quant(
        tree, 0.5, jspec, np.random.default_rng(1)))
    assert n * spec.wire_dtype.itemsize < got < \
        n * spec.wire_dtype.itemsize + 192


def _fold_both(trees, ns, bits, frac_bits, scales=None, rescale=1.0,
               weight_ints=None, seed=100):
    spec, jspec = _specs(bits, frac_bits)
    W = sum(ns)
    acc, jacc = SQ.SlotAccumulator(spec), JSQ.SlotAccumulator(jspec)
    for i, (t, n) in enumerate(zip(trees, ns)):
        wc = 1.0 if weight_ints is not None else n / W
        wi = 1 if weight_ints is None else int(weight_ints[i])
        acc.fold(SQ.encode_secure_quant(
            _flat(t), wc, spec, np.random.default_rng(seed + i),
            scales=scales), weight_int=wi)
        jacc.fold(JSQ.encode_secure_quant(
            t, wc, jspec, np.random.default_rng(seed + i), scales=scales),
            weight_int=wi)
    got = acc.finalize(like=_flat(trees[0]), rescale=rescale, scales=scales)
    want = jacc.finalize(like=trees[0], rescale=rescale, scales=scales)
    return got, _flat(want)


@pytest.mark.parametrize("bits,frac_bits", SPECS)
def test_fold_equals_reference_and_quantized_mean(bits, frac_bits):
    """The slot-major fold of masked frames, finalized, against the
    reference's fold and the plain quantized weighted mean (the port's
    and the reference's), bit for bit: the masks cancel in the field."""
    trees = [_tree(s, bn=0.5) for s in range(4)]
    ns = [10.0, 20.0, 5.0, 7.0]
    spec, jspec = _specs(bits, frac_bits)
    got, want = _fold_both(trees, ns, bits, frac_bits)
    plain = SQ.quantized_weighted_mean([_flat(t) for t in trees], ns, spec)
    jplain = _flat(JSQ.quantized_weighted_mean(trees, ns, jspec))
    for k in want:
        _eq(got[k], want[k])
        _eq(plain[k], want[k])
        _eq(jplain[k], want[k])


def test_fold_with_leaf_scales_and_integer_weights():
    """BatchNorm-magnitude leaves through the scales and the one-phase
    integer weights (the engines' fold): equal to the reference's, and
    near the float mean."""
    trees = [_tree(s, bn=300.0) for s in range(5)]
    ns = [8.0, 11.0, 9.0, 12.0, 10.0]
    spec, jspec = _specs(32, 10)
    scales = SQ.leaf_scales(_flat(trees[0]))
    assert scales == JSQ.leaf_scales(trees[0])
    assert scales["batch_stats/m"] > 1.0 == scales["params/k"]
    wi, denom = SQ.integer_weights(ns, spec)
    jwi, jdenom = JSQ.integer_weights(ns, jspec)
    _eq(wi, jwi)
    assert denom == jdenom
    got, want = _fold_both(trees, ns, 32, 10, scales=scales,
                           rescale=1.0 / denom, weight_ints=wi)
    for k in want:
        _eq(got[k], want[k])
    fmean = np.average(np.stack([t["batch_stats"]["m"] for t in trees]), 0,
                       weights=wi)
    np.testing.assert_allclose(got["batch_stats/m"], fmean, rtol=0,
                               atol=2 * scales["batch_stats/m"] * 2.0 ** -10)


def test_dropout_rescale_over_the_survivors():
    """A client that dropped is never folded; ``rescale = 1 / W`` over the
    survivors' weight mass gives their weighted mean, as the reference's
    fold does, and equals their plain quantized mean rescaled."""
    trees = [_tree(s, bn=0.5) for s in range(4)]
    ns = [10.0, 20.0, 5.0, 7.0]
    W = sum(ns)
    spec, jspec = _specs(16, 10)
    surv = [0, 1, 3]
    acc, jacc = SQ.SlotAccumulator(spec), JSQ.SlotAccumulator(jspec)
    for i in surv:
        acc.fold(SQ.encode_secure_quant(_flat(trees[i]), ns[i] / W, spec,
                                        np.random.default_rng(7 + i)))
        jacc.fold(JSQ.encode_secure_quant(trees[i], ns[i] / W, jspec,
                                          np.random.default_rng(7 + i)))
    w_surv = sum(ns[i] for i in surv) / W
    got = acc.finalize(like=_flat(trees[0]), rescale=1.0 / w_surv)
    want = _flat(jacc.finalize(like=trees[0], rescale=1.0 / w_surv))
    for k in want:
        _eq(got[k], want[k])
        q = None
        for i in surv:
            qi = mpc.quantize32(np.float32(ns[i] / W)
                                * _flat(trees[i])[k].reshape(-1),
                                p=spec.p, frac_bits=spec.frac_bits)
            q = qi if q is None else (q + qi) % spec.p
        deq = mpc.dequantize32(q, p=spec.p, frac_bits=spec.frac_bits)
        _eq(got[k], np.asarray((1.0 / w_surv) * deq, np.float64).reshape(
            got[k].shape).astype(np.float32))


def test_slot_intermediates_never_equal_a_plaintext():
    """No slot accumulator the server holds after any fold equals a
    client's quantized update; the trace is the reference's."""
    trees = [_tree(s, bn=0.5) for s in range(4)]
    spec, jspec = _specs(16, 10)
    tr, jtr = [], []
    acc = SQ.SlotAccumulator(spec, trace=tr)
    jacc = JSQ.SlotAccumulator(jspec, trace=jtr)
    for i, t in enumerate(trees):
        acc.fold(SQ.encode_secure_quant(_flat(t), 0.25, spec,
                                        np.random.default_rng(50 + i)))
        jacc.fold(JSQ.encode_secure_quant(t, 0.25, jspec,
                                          np.random.default_rng(50 + i)))
    assert len(tr) == len(jtr) == 4 * spec.n_shares
    for a, b in zip(tr, jtr):
        _eq(a, b)
    qs = [np.concatenate([mpc.quantize32(np.float32(0.25) * x.reshape(-1),
                                         p=spec.p, frac_bits=10)
                          for x in _flat(t).values()]) for t in trees]
    for inter in tr:
        for q in qs:
            assert not np.array_equal(inter, q)


def test_merge_and_export_centered():
    """Per-worker accumulators merged in either order equal one fold of
    every frame, and the reference's merge; the centred export is the
    reference's and sums exactly in int64 across partials."""
    trees = [_tree(s, bn=0.5) for s in range(4)]
    spec, jspec = _specs(32, 10)
    frames = [SQ.encode_secure_quant(_flat(t), 1.0, spec,
                                     np.random.default_rng(30 + i))
              for i, t in enumerate(trees)]
    jframes = [JSQ.encode_secure_quant(t, 1.0, jspec,
                                       np.random.default_rng(30 + i))
               for i, t in enumerate(trees)]
    wi = [3, 1, 2, 5]

    def accs(mod, spec_, fr, parts):
        out = []
        for part in parts:
            a = mod.SlotAccumulator(spec_)
            for i in part:
                a.fold(fr[i], weight_int=wi[i])
            out.append(a)
        return out

    one = accs(SQ, spec, frames, [[0, 1, 2, 3]])[0]
    whole = one.export_centered()
    a, b = accs(SQ, spec, frames, [[0, 2], [1, 3]])
    ja, jb = accs(JSQ, jspec, jframes, [[0, 2], [1, 3]])
    pa, pb = a.export_centered(), b.export_centered()
    jpa = ja.export_centered()
    for k in whole:
        _eq(pa[k], jpa[k])
        np.testing.assert_array_equal(pa[k] + pb[k], whole[k])
    b2, _ = accs(SQ, spec, frames, [[1, 3], []])
    b2.merge(a)
    a.merge(b)
    ja.merge(jb)
    assert a.folded == b2.folded == ja.folded == 4
    like = _flat(trees[0])
    fa, fb = a.finalize(like=like), b2.finalize(like=like)
    fj = _flat(ja.finalize(like=trees[0]))
    fo = one.finalize(like=like)
    for k in fj:
        _eq(fa[k], fj[k])
        _eq(fb[k], fj[k])
        _eq(fo[k], fj[k])
    assert SQ.SlotAccumulator(spec).export_centered() is None
    empty = SQ.SlotAccumulator(spec)
    empty.merge(SQ.SlotAccumulator(spec))
    assert empty.folded == 0


def test_merge_refusals():
    spec, jspec = _specs(32, 10)
    a = SQ.SlotAccumulator(spec)
    a.fold(SQ.encode_secure_quant({"w": np.ones(4, np.float32)}, 1.0, spec,
                                  np.random.default_rng(0)))
    with pytest.raises(ValueError, match="cannot merge SlotAccumulators "
                                         "with different specs"):
        SQ.SlotAccumulator(SQ.QuantSpec.from_bits(16)).merge(a)
    other = SQ.SlotAccumulator(spec)
    other.fold(SQ.encode_secure_quant({"v": np.ones(4, np.float32)}, 1.0,
                                      spec, np.random.default_rng(1)))
    for target in (a, SQ.SlotAccumulator(spec,
                                         like={"w": np.ones(4)})):
        with pytest.raises(ValueError, match="accumulator merge: leaf "
                                             "structure mismatch"):
            target.merge(other)


def test_fold_is_atomic_on_structure_skew():
    """A frame whose leaves differ raises before any accumulator changes
    (the fold still finalizes to the good frames' mean), with a template
    even for the first frame; a truncated seed list and a bad weight are
    refused."""
    spec, _ = _specs(16, 10)
    good = [{"a": np.full(4, 0.5, np.float32),
             "b": np.full(2, 0.25, np.float32)} for _ in range(2)]
    acc = SQ.SlotAccumulator(spec)
    for i, t in enumerate(good):
        acc.fold(SQ.encode_secure_quant(t, 0.5, spec,
                                        np.random.default_rng(i)))
    skew = SQ.encode_secure_quant({"a": np.ones(4, np.float32),
                                   "c": np.ones(2, np.float32)}, 0.5, spec,
                                  np.random.default_rng(9))
    msg = "secure-quant frame leaf structure mismatch"
    with pytest.raises(ValueError, match=msg):
        acc.fold(skew)
    assert acc.folded == 2
    got = acc.finalize(like=good[0])
    want = SQ.quantized_weighted_mean(good, [1.0, 1.0], spec)
    for k in ("a", "b"):
        _eq(got[k], want[k])
    with pytest.raises(ValueError, match=msg):
        SQ.SlotAccumulator(spec, like=good[0]).fold(skew)
    bad = SQ.encode_secure_quant(good[0], 0.5, spec,
                                 np.random.default_rng(1))
    bad["seeds"] = bad["seeds"][:1]
    with pytest.raises(ValueError, match="secure-quant frame carries 1 "
                                         "mask seeds, expected n_shares - "
                                         "1 = 2"):
        SQ.SlotAccumulator(spec).fold(bad)
    with pytest.raises(ValueError, match="weight_int must be >= 1"):
        SQ.SlotAccumulator(spec).fold(
            SQ.encode_secure_quant(good[0], 0.5, spec,
                                   np.random.default_rng(1)), 0)
    with pytest.raises(ValueError, match=r"finalize\(\) before any frame "
                                         "folded"):
        SQ.SlotAccumulator(spec).finalize(like=good[0])


def test_frame_spec_version_and_magic_refusals():
    spec, _ = _specs(16, 10)
    frame = SQ.encode_secure_quant({"w": np.ones(4, np.float32)}, 1.0, spec,
                                   np.random.default_rng(0))
    with pytest.raises(ValueError, match=r"secure-quant spec mismatch: "
                                         r"frame carries \(p, frac_bits, "
                                         r"n_shares\) = \(65521, 10, 3\)"):
        SQ.SlotAccumulator(SQ.QuantSpec.from_bits(32)).fold(frame)
    with pytest.raises(ValueError, match="without the frame magic — the "
                                         "sender is not running "
                                         "--secure_quant"):
        SQ.SlotAccumulator(spec).fold({"w": np.ones(4)})
    old = dict(frame, **{SQ.SECURE_QUANT_KEY: 2})
    with pytest.raises(ValueError, match="secure-quant frame version 2 != "
                                         "supported 1"):
        SQ.SlotAccumulator(spec).fold(old)
    assert SQ.is_secure_quant_frame(frame)
    assert not SQ.is_secure_quant_frame({"w": 1})


@pytest.mark.parametrize("weights", [[6.0, 3.0, 1.5], [1.0] * 7,
                                     [9.0, 1e-3, 4.0, 4.0],
                                     [0.0, 2.0, 5.0]])
def test_integer_weights_equal_reference(weights):
    spec, jspec = _specs(32, 10)
    wi, denom = SQ.integer_weights(weights, spec)
    jwi, jdenom = JSQ.integer_weights(weights, jspec)
    _eq(wi, jwi)
    assert denom == jdenom == float(np.sum(wi))
    assert (wi >= 1).all()


def test_integer_weights_refusals():
    spec, _ = _specs(16, 10)
    with pytest.raises(ValueError, match="weighted-fold headroom "
                                         "exhausted.*field_bits 32"):
        SQ.integer_weights([5.0, 4.0, 3.0, 2.0], spec)
    for bad in ([], [1.0, np.nan], [-1.0, 2.0], [0.0, 0.0]):
        with pytest.raises(ValueError, match="weights must be finite, "
                                             "non-negative, with max > 0"):
            SQ.integer_weights(bad, _specs(32, 10)[0])
    assert SQ.weighted_fold_capacity(spec) == \
        JSQ.weighted_fold_capacity(JSQ.QuantSpec.from_bits(16))


@pytest.mark.parametrize("bits,frac_bits,n_shares,cohort", [
    (16, 10, 3, 21), (32, 16, 3, 6), (8, 3, 2, 4), (16, 16, 3, 4),
    (8, 10, 3, 4), (16, 10, 1, 4), (32, 10, 3, 2**31 + 7),
    (32, 0, 3, 4)])
def test_check_headroom_matches_reference(bits, frac_bits, n_shares, cohort):
    spec = SQ.QuantSpec.from_bits(bits, frac_bits, n_shares)
    jspec = JSQ.QuantSpec.from_bits(bits, frac_bits, n_shares)
    try:
        JSQ.check_headroom(jspec, cohort)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            SQ.check_headroom(spec, cohort)
        assert str(got.value) == str(e)
    else:
        SQ.check_headroom(spec, cohort)


def test_check_headroom_field_modulus_and_bits():
    with pytest.raises(ValueError, match=r"field modulus 4294967291 outside "
                                         r"\(1, 2\^31\)"):
        SQ.check_headroom(SQ.QuantSpec(p=2**32 - 5), 4)
    with pytest.raises(ValueError, match=r"secure_quant_field_bits must be "
                                         r"one of \[8, 16, 32\] \(got 12\)"):
        SQ.QuantSpec.from_bits(12)
    assert SQ.QuantSpec() == SQ.QuantSpec.from_bits(16)
    assert SQ.QuantSpec.from_bits(8).wire_dtype == np.uint8


@pytest.mark.parametrize("peak", [0.0, 0.5, 7.9, 8.0, 8.1, 40.0, 300.0,
                                  1e5])
def test_leaf_scales_match_reference(peak):
    ref = {"params": {"w": np.asarray([peak, -0.25], np.float32),
                      "e": np.zeros(0, np.float32)},
           "batch_stats": {"v": np.asarray([-peak, 1.0], np.float32)}}
    got = SQ.leaf_scales(ref)
    assert got == JSQ.leaf_scales(ref)
    assert got == SQ.leaf_scales(_flat(ref))
    for s in got.values():
        assert s >= 1.0 and np.log2(s) == int(np.log2(s))


def test_decode_update_refuses_a_secure_frame():
    """The plain decode path refuses a field-element frame with the
    reference's message (masked residues decoded as floats would poison
    the aggregate)."""
    from neuroimagedisttraining_tpu.codec import wire as jwire
    from neuroimagedisttraining_tpu_torch.codec import wire

    assert wire.SECURE_QUANT_KEY == jwire.SECURE_QUANT_KEY
    spec, _ = _specs(16, 10)
    frame = SQ.encode_secure_quant({"w": np.ones(4, np.float32)}, 1.0, spec,
                                   np.random.default_rng(0))
    msg = ("received a secure-quant field-element frame on the plain "
           "decode path: its values are masked GF(p) residues, not model "
           "floats — the receiver must run the secure-quant server "
           "(--secure_quant on every rank; see privacy/secure_quant.py")
    for mod in (wire, jwire):
        with pytest.raises(ValueError, match=re.escape(msg)):
            mod.decode_update(frame, like={"w": np.ones(4, np.float32)})
