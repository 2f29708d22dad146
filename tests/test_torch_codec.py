"""The port's wire codec (``codec/``) against the reference package's:
``parse_wire_spec`` accepts and refuses the same strings; the device
roundtrip ``lossy_roundtrip`` equals the reference's bit for bit for every
spec, with and without masks and error feedback, on residual-like updates
(log-normal magnitudes near 1e-4 with a few outliers, the codec's scores
after a local epoch) and on an all-NaN row; the port's ``kth_largest``
on such scores keeps the same set as the reference's jitted
``kth_largest`` and ``np.partition``; the host frames are byte-identical to the
reference's (``encode_update``), decode to the same values, and their
``frame_nbytes`` is flax's msgpack count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.codec import device as jdev
from neuroimagedisttraining_tpu.codec import wire as jw
from neuroimagedisttraining_tpu.ops.topk import kth_largest as jkth
from neuroimagedisttraining_tpu_torch.codec import device as pdev
from neuroimagedisttraining_tpu_torch.codec import wire as pw
from neuroimagedisttraining_tpu_torch.ops.topk import kth_largest as pkth

SPECS = ["delta", "sparse", "quant", "quant16", "delta+sparse",
         "delta+quant", "sparse+quant", "delta+sparse+quant",
         "delta+sparse+quant16", "quant+delta+sparse"]
SHAPES = {"params": {"conv": {"kernel": (3, 3, 3, 1, 8), "bias": (8,)},
                     "dense": {"kernel": (40, 3), "bias": (3,)}},
          "batch_stats": {"bn": {"mean": (8,), "var": (8,)}}}


def _residual_like(shape, rng, outliers=3):
    mag = np.exp(rng.normal(np.log(1e-4), 1.0, size=shape))
    x = (np.where(rng.random(shape) < 0.5, -1, 1) * mag).astype(np.float32)
    flat = x.reshape(-1)
    flat[rng.choice(flat.size, min(outliers, flat.size), replace=False)] *= 1e3
    return x


def _case(seed=0, ef=False):
    """(update, reference, masks, ef) as nested numpy trees: the update
    a residual-like move off the reference."""
    rng = np.random.default_rng(seed)
    leaf = lambda f: jax.tree.map(f, SHAPES,  # noqa: E731
                                  is_leaf=lambda x: isinstance(x, tuple))
    ref = leaf(lambda s: rng.normal(size=s).astype(np.float32))
    upd = jax.tree.map(lambda r: r + _residual_like(r.shape, rng), ref)
    masks = leaf(lambda s: (rng.random(s) < 0.5).astype(np.float32))
    masks["batch_stats"] = jax.tree.map(np.ones_like, masks["batch_stats"])
    e = (jax.tree.map(lambda r: _residual_like(r.shape, rng, 1), ref)
         if ef else None)
    return upd, ref, masks, e


def _named(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _t(tree):
    return None if tree is None else {
        n: torch.from_numpy(v.copy()) for n, v in _named(tree).items()}


@pytest.mark.parametrize("text", SPECS + ["none", "", "  Delta+QUANT "])
def test_parse_accepts_as_reference(text):
    for ratio in (0.25, 1.0, 0.01):
        got, ref = pw.parse_wire_spec(text, ratio), jw.parse_wire_spec(
            text, ratio)
        assert (got is None) == (ref is None)
        if got is not None:
            assert (got.delta, got.sparse, got.quant, got.topk_ratio,
                    got.canonical, got.needs_ef) == (
                ref.delta, ref.sparse, ref.quant, ref.topk_ratio,
                ref.canonical, ref.needs_ef)


@pytest.mark.parametrize("text,ratio", [("delta+none", 0.25),
                                        ("delta+zip", 0.25),
                                        ("sparse", 0.0), ("sparse", 1.5)])
def test_parse_refuses_as_reference(text, ratio):
    with pytest.raises(ValueError) as ref:
        jw.parse_wire_spec(text, ratio)
    with pytest.raises(ValueError) as got:
        pw.parse_wire_spec(text, ratio)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("text", SPECS)
@pytest.mark.parametrize("mode", ["plain", "masks", "ef"])
def test_lossy_roundtrip_equals_reference(text, mode):
    """Decoded upload and next error feedback bit for bit (equal
    thresholds, hence equal keep sets and per-leaf int8 scales)."""
    spec_j, spec_p = jw.parse_wire_spec(text), pw.parse_wire_spec(text)
    upd, ref, masks, ef = _case(seed=len(text), ef=mode == "ef")
    kw_j = dict(reference=ref if spec_j.delta else None,
                masks=masks if mode == "masks" else None, ef=ef)
    dec_j, ef_j = jdev.lossy_roundtrip(spec_j, upd, **kw_j)
    dec_p, ef_p = pdev.lossy_roundtrip(
        spec_p, _t(upd), reference=_t(kw_j["reference"]),
        masks=_t(kw_j["masks"]), ef=_t(ef))
    for n, v in _named(jax.tree.map(np.asarray, dec_j)).items():
        np.testing.assert_array_equal(dec_p[n].numpy(), v, err_msg=n)
    assert (ef_p is None) == (ef_j is None)
    if ef_j is not None:
        for n, v in _named(jax.tree.map(np.asarray, ef_j)).items():
            np.testing.assert_array_equal(ef_p[n].numpy(), v, err_msg=n)


@pytest.mark.parametrize("text", ["delta+sparse+quant", "sparse",
                                  "delta+sparse+quant16"])
def test_nan_row_equals_reference(text):
    """An all-NaN upload (the ``nonfinite`` attack reaches the codec before
    the guard): the select's NaN threshold keeps nothing, as the
    reference's."""
    spec_j, spec_p = jw.parse_wire_spec(text), pw.parse_wire_spec(text)
    upd, ref, _, ef = _case(seed=5, ef=True)
    upd = jax.tree.map(lambda x: np.full_like(x, np.nan), upd)
    dec_j, ef_j = jdev.lossy_roundtrip(spec_j, upd, reference=ref if
                                       spec_j.delta else None, ef=ef)
    dec_p, ef_p = pdev.lossy_roundtrip(
        spec_p, _t(upd), reference=_t(ref) if spec_p.delta else None,
        ef=_t(ef))
    for n, v in _named(jax.tree.map(np.asarray, dec_j)).items():
        np.testing.assert_array_equal(dec_p[n].numpy(), v, err_msg=n)
    for n, v in _named(jax.tree.map(np.asarray, ef_j)).items():
        np.testing.assert_array_equal(ef_p[n].numpy(), v, err_msg=n)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ratio", [0.25, 0.01, 0.9])
def test_kth_largest_on_residuals(seed, ratio):
    """The codec's select on residual magnitudes: the port's threshold is
    bit-equal to the reference's ``kth_largest`` run op by op, and its
    keep set ``x >= thr`` equals that of the reference's jitted select (its
    XLA counting on the CPU, as its own tests run it) and of the host
    frame's ``np.partition``, so the device and host paths keep one
    support set. The threshold values themselves may differ from the
    jitted one and from ``np.partition`` by an ulp with no score between
    (XLA rewrites the ladder's ``linspace`` inside ``jit``; near the bottom
    of these heavy-tailed scores, at 90%, 4 x 512 bins stop at float
    resolution below the k-th value: ROADMAP Queue 3)."""
    rng = np.random.default_rng(seed)
    x = np.abs(_residual_like((20011,), rng, outliers=7))
    k = int(np.ceil(ratio * x.size))
    got = pkth(torch.from_numpy(x), k).numpy()
    with jax.disable_jit():
        assert got == np.asarray(jkth(jnp.asarray(x), k))
    keep = x >= got
    assert keep.sum() >= k
    np.testing.assert_array_equal(keep, x >= np.asarray(jkth(jnp.asarray(x),
                                                             k)))
    np.testing.assert_array_equal(keep, x >= jw._topk_threshold_np(x, k))
    assert pw._topk_threshold_np(x, k) == jw._topk_threshold_np(x, k)


@pytest.mark.parametrize("text", SPECS)
@pytest.mark.parametrize("mode", ["plain", "masks", "shared", "ef"])
def test_frames_equal_reference(text, mode):
    """``encode_update``: the frame's body byte for byte, its size by
    ``frame_nbytes`` equal to flax's msgpack count, the next error
    feedback equal, and the frame decoded to the reference's values."""
    spec_j, spec_p = jw.parse_wire_spec(text), pw.parse_wire_spec(text)
    upd, ref, masks, ef = _case(seed=1, ef=mode == "ef")
    m = masks if mode in ("masks", "shared") else None
    kw = dict(reference=ref if spec_j.delta else None, masks=m, ef=ef,
              mask_on_wire=mode != "shared")
    fj, ef_j = jw.encode_update(spec_j, upd, **kw)
    fp, ef_p = pw.encode_update(
        spec_p, _named(upd), reference=_named(ref) if spec_j.delta else None,
        masks=_named(m) if m is not None else None,
        ef=_named(ef) if ef is not None else None,
        mask_on_wire=mode != "shared")
    np.testing.assert_array_equal(fp["body"], fj["body"])
    assert {k: v for k, v in fp.items() if k != "body"} == {
        k: v for k, v in fj.items() if k != "body"}
    assert pw.frame_nbytes(fp) == jw.frame_nbytes(fj)
    assert (ef_p is None) == (ef_j is None)
    if ef_j is not None:
        for n, v in _named(ef_j).items():
            np.testing.assert_array_equal(ef_p[n], v, err_msg=n)
    dj = _named(jw.decode_update(fj, like=upd, reference=ref, masks=m))
    dp = pw.decode_update(fp, like=_named(upd), reference=_named(ref),
                          masks=_named(m) if m is not None else None)
    assert list(dp) == list(dj)
    for n, v in dj.items():
        np.testing.assert_array_equal(dp[n], v, err_msg=n)


def test_dense_bytes_and_msgpack_round_trip():
    """The dense upload's msgpack size as flax counts it, and the port's
    decoder reading flax's bytes back."""
    from flax import serialization

    upd, _, _, _ = _case(seed=2)
    named = _named(upd)
    want = serialization.msgpack_serialize(jax.tree.map(np.asarray, upd))
    assert pw.msgpack_dumps(pw.nest(named)) == want
    assert pw.frame_nbytes(pw.nest(named)) == jw.frame_nbytes(upd)
    back = pw.msgpack_loads(want)
    for n, v in _named(back).items():
        np.testing.assert_array_equal(v, named[n])
    odd = {"s" * 40: [-1, -33, 200, 70000, 2 ** 40, -2 ** 20], "f": 0.5,
           "b": b"\x00" * 300, "n": None, "t": True}
    assert pw.msgpack_dumps(odd) == serialization.msgpack_serialize(odd)
    assert pw.msgpack_loads(pw.msgpack_dumps(odd)) == odd


def test_shared_mask_frame_needs_the_mask():
    spec = pw.parse_wire_spec("delta+sparse")
    upd, ref, masks, _ = _case(seed=3)
    frame, _ = pw.encode_update(spec, _named(upd), reference=_named(ref),
                                masks=_named(masks), mask_on_wire=False)
    with pytest.raises(ValueError, match="shared-mask mode"):
        pw.decode_update(frame, like=_named(upd), reference=_named(ref))
    assert pw.decode_update({"dense": 1}, like={}) == {"dense": 1}
