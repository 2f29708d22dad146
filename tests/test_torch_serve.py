"""The port's serving plane (``serve/``) against the reference package's,
on the CPU, with ``3dcnn_tiny`` at 12x14x12 as the reference's own serving
tests use it.

- Bundles: both packages' ``build_bundle`` on one checkpoint give equal
  ``manifest.json`` and ``weights.msgpack`` bytes for each flavor (fedavg,
  salientgrads, ditto, fedfomo) and stored precision (bf16, fp32), also
  from a checkpoint the port's ``save_checkpoint`` wrote; each package
  loads the other's bundles; every drift gives the same message in both.
- bf16 without ``ml_dtypes``: a port-only process reads a bf16 bundle the
  JAX package wrote, bit for bit.
- Logits: the same bundle in both packages' ``ServeEngine`` answers the
  same requests at every bucket, fp32 within 1e-5 of the logit scale and
  bf16 under the reference's own bf16 pin (0.1 absolute); a padded row
  equals its bucket-1 answer.
- The engine contract (programs per bucket, the recompile tripwire, the
  shape fence, the precision override, concurrent sites) and equal
  ``stats()`` for one submit sequence; an engine or worker asked for
  ``cuda`` without a card raises.
- HTTP: two spawned workers on the CPU, JSON and raw bodies, the verdicts
  and a reconciled audit.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.models import create_model as jcreate_model
from neuroimagedisttraining_tpu.serve import bundle as jbundle
from neuroimagedisttraining_tpu.serve.engine import ServeEngine as JEngine
from neuroimagedisttraining_tpu.utils.checkpoint import (
    save_checkpoint as jsave_checkpoint,
)
from neuroimagedisttraining_tpu_torch.obs import compute as obs_compute
from neuroimagedisttraining_tpu_torch.serve import bundle as pbundle
from neuroimagedisttraining_tpu_torch.serve.bundle import (
    GLOBAL_KEY, MANIFEST_NAME, WEIGHTS_NAME, BundleError,
)
from neuroimagedisttraining_tpu_torch.serve.engine import ServeEngine
from neuroimagedisttraining_tpu_torch.utils.checkpoint import (
    save_checkpoint as psave_checkpoint,
)

SHAPE = (12, 14, 12)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the reference's bf16 pin (its tests/test_serve.py: tiny-model logits
#: are O(1), bf16 carries ~8 mantissa bits)
BF16_PIN = 0.1


def _init_tree(seed=0):
    m = jcreate_model("3dcnn_tiny", num_classes=1)
    v = m.init({"params": jax.random.PRNGKey(seed),
                "dropout": jax.random.PRNGKey(seed + 1)},
               jnp.zeros((1, *SHAPE, 1)), train=False)
    return (jax.tree.map(np.asarray, v["params"]),
            jax.tree.map(np.asarray, v.get("batch_stats", {})))


def _stack(tree, n):
    # i+1: row 0 must not equal the global params, or the per-site
    # digests would collide with the global one
    return jax.tree.map(
        lambda x: np.stack([x * np.float32(1.0 + 0.1 * (i + 1))
                            for i in range(n)]), tree)


def _states():
    """One checkpoint state a flavor, numpy trees."""
    params, bstats = _init_tree()
    rng = np.random.default_rng(7)
    masks = jax.tree.map(
        lambda p: (rng.random(np.shape(p)) < 0.5).astype(np.float32), params)
    return {
        "fedavg": {"params": params, "batch_stats": bstats, "history": []},
        "salientgrads": {"params": params, "batch_stats": bstats,
                         "masks": masks, "history": []},
        "ditto": {"params": params, "batch_stats": bstats,
                  "per_params": _stack(params, 2),
                  "per_bstats": _stack(bstats, 2)},
        "fedfomo": {"per_params": _stack(params, 3),
                    "per_bstats": _stack(bstats, 3),
                    "weights": np.eye(3, dtype=np.float32),
                    "p_choose": np.ones((3, 3), np.float32) / 3,
                    "history": []},
    }


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Each flavor's checkpoint, written by the JAX package, and the ditto
    state written again by the port's ``save_checkpoint`` (with a
    generator leaf, which a bundle ignores)."""
    root = tmp_path_factory.mktemp("torch_serve")
    out, states = {}, _states()
    for flavor, state in states.items():
        ck = str(root / f"ck_{flavor}")
        jsave_checkpoint(ck, 5, state)
        out[flavor] = ck
    ck = str(root / "ck_port_ditto")
    psave_checkpoint(ck, 5, {**states["ditto"],
                             "generator": torch.Generator().manual_seed(3)})
    out["port_ditto"] = ck
    return out


def _build(mod, ck, out, **kw):
    kw.setdefault("model", "3dcnn_tiny")
    kw.setdefault("num_classes", 1)
    kw.setdefault("input_shape", SHAPE)
    return mod.build_bundle(ck, str(out), **kw)


def _files(d):
    return {n: (d / n).read_bytes() for n in (MANIFEST_NAME, WEIGHTS_NAME)}


@pytest.fixture(scope="module")
def ditto_bundles(ckpts, tmp_path_factory):
    """The ditto checkpoint as a bf16 and an fp32 bundle (the JAX
    package's build)."""
    root = tmp_path_factory.mktemp("torch_serve_b")
    out = {}
    for prec in ("bf16", "fp32"):
        _build(jbundle, ckpts["ditto"], root / prec, precision=prec)
        out[prec] = str(root / prec)
    return out


# ---------------------------------------------------------------------------
# bundles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
@pytest.mark.parametrize("flavor", ["fedavg", "salientgrads", "ditto",
                                    "fedfomo", "port_ditto"])
def test_bundles_byte_equal(ckpts, tmp_path, flavor, precision):
    """Both packages' bundles of one checkpoint are equal byte for byte
    (so their sha256s and per-model digests are too), and each package
    loads the other's."""
    mj = _build(jbundle, ckpts[flavor], tmp_path / "j", precision=precision)
    mp = _build(pbundle, ckpts[flavor], tmp_path / "p", precision=precision)
    assert mp == mj
    assert _files(tmp_path / "p") == _files(tmp_path / "j")
    assert mp["flavor"] == flavor.removeprefix("port_")
    if flavor == "salientgrads":
        assert 0 < mp["sparse_nnz"] < mp["total_params"]
    pj = pbundle.load_bundle(str(tmp_path / "j"))
    jp = jbundle.load_bundle(str(tmp_path / "p"))
    assert pj.manifest == jp.manifest
    assert pj.sites == jp.sites and set(pj.models) == set(jp.models)
    # the port's loaded trees serialize back to the committed payload
    from neuroimagedisttraining_tpu_torch.codec.wire import msgpack_dumps

    assert msgpack_dumps(pj.models) == (tmp_path / "j" / WEIGHTS_NAME
                                        ).read_bytes()
    lead = pj.models[GLOBAL_KEY]["params"]["f0"]["conv"]["kernel"]
    assert lead.dtype == (torch.bfloat16 if precision == "bf16"
                          else np.float32)


def _err(fn):
    try:
        fn()
    except BundleError as e:
        return type(e).__name__, str(e)
    except jbundle.BundleError as e:
        return type(e).__name__, str(e)
    raise AssertionError("no BundleError raised")


def test_drift_messages_equal(ckpts, tmp_path):
    """Every drift the reference refuses is refused by the port with the
    same message: missing, corrupt, stale and wrong-version manifests,
    weights drift, a model digest drift, a model-set mismatch, a missing
    checkpoint and a bad precision."""
    bdir = tmp_path / "bundle"
    _build(jbundle, ckpts["ditto"], bdir)
    mpath, wpath = bdir / MANIFEST_NAME, bdir / WEIGHTS_NAME
    good_m, good_w = mpath.read_text(), wpath.read_bytes()

    def both_load(path):
        msgs = (_err(lambda: jbundle.load_bundle(str(path))),
                _err(lambda: pbundle.load_bundle(str(path))))
        assert msgs[0] == msgs[1]
        return msgs[1][1]

    assert "not a bundle" in both_load(tmp_path / "nowhere")
    mpath.write_text(good_m[:-20])
    assert "corrupt manifest" in both_load(bdir)
    doc = json.loads(good_m)
    del doc["sites"]
    mpath.write_text(json.dumps(doc))
    assert "stale manifest" in both_load(bdir)
    doc = json.loads(good_m)
    doc["bundle_version"] = 99
    mpath.write_text(json.dumps(doc))
    assert "version mismatch" in both_load(bdir)
    mpath.write_text(good_m)
    raw = bytearray(good_w)
    raw[len(raw) // 2] ^= 0xFF
    wpath.write_bytes(bytes(raw))
    assert "weights drift" in both_load(bdir)
    wpath.write_bytes(good_w)
    doc = json.loads(good_m)
    a, b = doc["models"]["site:0"], doc["models"]["site:1"]
    doc["models"]["site:0"], doc["models"]["site:1"] = b, a
    mpath.write_text(json.dumps(doc))
    assert "drift" in both_load(bdir)
    doc = json.loads(good_m)
    doc["sites"] = ["0", "1", "2"]
    mpath.write_text(json.dumps(doc))
    assert "manifest declares" in both_load(bdir)
    wpath.unlink()
    mpath.write_text(good_m)
    assert "missing" in both_load(bdir)

    def both_build(ck, **kw):
        msgs = (_err(lambda: _build(jbundle, ck, tmp_path / "b", **kw)),
                _err(lambda: _build(pbundle, ck, tmp_path / "b", **kw)))
        assert msgs[0] == msgs[1]
        return msgs[1][1]

    assert "no checkpoints" in both_build(str(tmp_path / "empty"))
    assert "precision" in both_build(str(tmp_path / "empty"),
                                     precision="fp16")


def test_bf16_bundle_read_without_ml_dtypes(ditto_bundles, tmp_path):
    """A process that imports only the port reads the JAX package's bf16
    bundle: its weights are the reference's bits, and neither
    ``ml_dtypes`` nor ``jax`` is imported."""
    out = tmp_path / "bits.npz"
    code = (
        "import sys, numpy as np, torch\n"
        "from neuroimagedisttraining_tpu_torch.serve.bundle import "
        "load_bundle\n"
        f"b = load_bundle({ditto_bundles['bf16']!r})\n"
        "k = b.models['site:1']['params']['f0']['conv']['kernel']\n"
        "assert k.dtype == torch.bfloat16, k.dtype\n"
        f"np.savez({str(out)!r}, bits=k.view(torch.int16).numpy())\n"
        "bad = [m for m in ('ml_dtypes', 'jax', 'flax') if m in sys.modules]"
        "\nassert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env={**os.environ, "PYTHONPATH": REPO})
    ref = jbundle.load_bundle(ditto_bundles["bf16"])
    want = np.asarray(ref.models["site:1"]["params"]["f0"]["conv"]["kernel"])
    assert want.dtype.name == "bfloat16"
    np.testing.assert_array_equal(np.load(out)["bits"],
                                  want.view(np.int16))


def test_bf16_round_is_ml_dtypes_cast():
    """The bundle's float32 -> bfloat16 cast equals ``ml_dtypes``' on
    ties, subnormals, infinities and signed NaNs."""
    import ml_dtypes

    specials = np.array([0x7F800001, 0xFF800001, 0x7FBFFFFF, 0x3F808000,
                         0x3F818000, 0x7F7FFFFF, 0x00000001, 0x80007FFF,
                         0x7F800000, 0xFF800000, 0, 0x80000000], np.uint32)
    x = np.concatenate([specials.view(np.float32),
                        np.random.default_rng(0).normal(size=4096).astype(
                            np.float32) * 1e3]).reshape(4, -1)
    with np.errstate(invalid="ignore"):  # the NaNs' cast
        want = x.astype(ml_dtypes.bfloat16).view(np.int16)
    got = pbundle.bf16_round(x).view(torch.int16).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# logits and the engine
# ---------------------------------------------------------------------------


def _requests(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=SHAPE).astype(np.float32) for _ in range(n)]


def _batched(eng, site, xs):
    """``xs`` submitted together: one dispatch at the smallest bucket
    that holds them (the engines wait up to their max_queue_ms)."""
    pends = [eng.submit(site, x)[0] for x in xs]
    for p in pends:
        assert p.event.wait(60.0)
        assert p.error is None, p.error
    return np.stack([p.result for p in pends])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_logits_match_reference(ditto_bundles, precision):
    """Both packages' engines on one bundle answer the same requests at
    buckets 1, 2 and 4 for every model key; a row padded into a larger
    bucket equals its bucket-1 answer."""
    jb = jbundle.load_bundle(ditto_bundles[precision])
    pb = pbundle.load_bundle(ditto_bundles[precision])
    je = JEngine(jb, batch_buckets=(1, 2, 4), max_queue_ms=50.0)
    pe = ServeEngine(pb, batch_buckets=(1, 2, 4), max_queue_ms=50.0,
                     device="cpu")
    xs = _requests(4)
    errs, pad_errs, scale = [], [], 0.0
    try:
        for site in (None, "0", "1"):
            ones_p = np.stack([pe.predict(site, x, 60.0)[0] for x in xs])
            ones_j = np.stack([je.predict(site, x, 60.0)[0] for x in xs])
            scale = max(scale, float(np.abs(ones_j).max()))
            errs.append(np.abs(ones_p - ones_j).max())
            for n in (2, 3, 4):  # buckets 2, 4 (padded) and 4
                yp = _batched(pe, site, xs[:n])
                yj = _batched(je, site, xs[:n])
                errs.append(np.abs(yp - yj).max())
                pad_errs.append(np.abs(yp - ones_p[:n]).max())
        sp, sj = pe.stats(), je.stats()
    finally:
        pe.close()
        je.close()
    assert sp == sj
    assert sp["batches"] == {"1": 12, "2": 3, "4": 6}, sp
    tol = 1e-5 * scale if precision == "fp32" else BF16_PIN
    # measured on the CPU: fp32 1.9e-6 at a logit scale of 1.51, bf16
    # 0.0156 (two bf16 steps at that scale); a padded row 1.9e-6 from its
    # bucket-1 answer in fp32 (the CPU's convolution differs by batch
    # size), 0 in bf16
    assert max(errs) <= tol, (max(errs), tol)
    assert max(pad_errs) <= 1e-5 * scale, (max(pad_errs), scale)


@pytest.fixture(scope="module")
def ditto_bundle(ditto_bundles):
    return pbundle.load_bundle(ditto_bundles["bf16"])


def _one_program_per_bucket(eng, x):
    """The reference's bucket sequence: 4 concurrent requests fill the
    largest bucket, 4 more replay it, a lone one pads to bucket 1."""
    pends = [eng.submit("0", x)[0] for _ in range(4)]
    for p in pends:
        assert p.event.wait(60.0)
        assert p.error is None and p.result is not None
    s = eng.stats()
    assert s["dispatches"] == 1 and s["batches"] == {"4": 1}, s
    assert s["compiles"] == 1 and s["compiled"] == ["site:0/b4"]
    pends = [eng.submit("0", x)[0] for _ in range(4)]
    for p in pends:
        assert p.event.wait(60.0)
    assert eng.stats()["compiles"] == 1
    y, key = eng.predict("0", x, timeout=60.0)
    assert key == "site:0" and y.shape == (1,)
    return eng.stats()


def test_engine_one_program_per_bucket(ditto_bundles, ditto_bundle):
    """N distinct (model, bucket) pairs -> exactly N programs on the
    shared counter (``nidt_compiles_total{engine="serve"}``), zero
    recompiles; the reference's engine gives the same ``stats()`` for the
    same submit sequence."""
    c0 = obs_compute.compiles_total(engine="serve")
    x = np.zeros(SHAPE, np.float32)
    eng = ServeEngine(ditto_bundle, batch_buckets=(1, 4),
                      max_queue_ms=200.0, device="cpu")
    try:
        s = _one_program_per_bucket(eng, x)
    finally:
        eng.close()
    assert s["compiles"] == 2 and s["recompiles"] == 0, s
    assert s["requests_dispatched"] == 9
    assert obs_compute.compiles_total(engine="serve") == c0 + 2
    je = JEngine(jbundle.load_bundle(ditto_bundles["bf16"]),
                 batch_buckets=(1, 4), max_queue_ms=200.0)
    try:
        assert _one_program_per_bucket(je, x) == s
    finally:
        je.close()


def test_engine_recompile_tripwire(ditto_bundle):
    """A second capture of the SAME (model, bucket) key hits the
    recompile counter."""
    eng = ServeEngine(ditto_bundle, batch_buckets=(1,), max_queue_ms=0.5,
                      device="cpu")
    try:
        x = np.zeros(SHAPE, np.float32)
        eng.predict(None, x, timeout=60.0)
        assert eng.stats()["recompiles"] == 0
        eng._sigs[(GLOBAL_KEY, 1)] = ("poisoned",)
        eng.predict(None, x, timeout=60.0)
        s = eng.stats()
        assert s["recompiles"] == 1 and s["compiles"] == 1, s
    finally:
        eng.close()


def test_engine_shape_fence_and_validation(ditto_bundle):
    eng = ServeEngine(ditto_bundle, batch_buckets=(2,), max_queue_ms=0.5,
                      device="cpu")
    try:
        with pytest.raises(ValueError, match="input shape"):
            eng.submit(None, np.zeros((3, 3), np.float32))
    finally:
        eng.close()
    with pytest.raises(ValueError, match="batch_buckets"):
        ServeEngine(ditto_bundle, batch_buckets=(), device="cpu")
    with pytest.raises(ValueError, match="precision"):
        ServeEngine(ditto_bundle, precision="fp16", device="cpu")


def test_engine_precision_override(ditto_bundles, ditto_bundle):
    """fp32 re-casts a bf16 bundle at load; bf16 rounds an fp32 bundle to
    the bf16 bundle's values."""
    eng = ServeEngine(ditto_bundle, batch_buckets=(1,), max_queue_ms=0.5,
                      precision="fp32", device="cpu")
    try:
        assert eng.precision == "fp32"
        assert eng._model.dtype == torch.float32
        lead = next(iter(eng._weights[GLOBAL_KEY][0].values()))
        assert lead.dtype == torch.float32
        y, _ = eng.predict(None, np.zeros(SHAPE, np.float32), timeout=60.0)
        assert np.all(np.isfinite(y))
    finally:
        eng.close()
    down = ServeEngine(pbundle.load_bundle(ditto_bundles["fp32"]),
                       batch_buckets=(1,), precision="bf16", device="cpu")
    stored = ServeEngine(ditto_bundle, batch_buckets=(1,), device="cpu")
    try:
        assert down.precision == "bf16" and down._model.dtype == torch.bfloat16
        for key in stored._weights:
            for a, b in zip(down._weights[key], stored._weights[key]):
                assert a.keys() == b.keys()
                assert all(torch.equal(a[k], b[k]) for k in a)
    finally:
        down.close()
        stored.close()


def test_engine_concurrent_sites_route_differently(ditto_bundle):
    eng = ServeEngine(ditto_bundle, batch_buckets=(1, 2), max_queue_ms=1.0,
                      device="cpu")
    try:
        x = np.random.default_rng(1).normal(size=SHAPE)
        results = {}

        def hit(site):
            y, key = eng.predict(site, x, timeout=60.0)
            results[site] = (float(y[0]), key)

        ts = [threading.Thread(target=hit, args=(s,)) for s in ("0", "1")]
        for t in ts:
            t.start()
        for t in ts:
            t.join(90.0)
        assert results["0"][1] == "site:0"
        assert results["1"][1] == "site:1"
        assert results["0"][0] != results["1"][0], results
    finally:
        eng.close()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_engine_on_missing_card_raises(ditto_bundle):
    """An engine asked for ``cuda`` (the default) without a card raises;
    it does not serve on the CPU."""
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        ServeEngine(ditto_bundle, batch_buckets=(1,))


# ---------------------------------------------------------------------------
# HTTP: two spawned workers
# ---------------------------------------------------------------------------


def test_http_two_workers_live(ditto_bundles):
    """Two SO_REUSEPORT workers on the CPU: JSON and raw /predict, the
    per-site digests distinct, malformed and unknown-site verdicts, the
    merged exposition worker-labeled, and a reconciled audit."""
    from neuroimagedisttraining_tpu_torch.serve.server import (
        ShardedServeServer,
    )

    srv = ShardedServeServer(ditto_bundles["bf16"], serve_workers=2,
                             batch_buckets=(1, 2), max_queue_ms=1.0,
                             device="cpu")
    try:
        url = f"http://127.0.0.1:{srv.port}"
        x = _requests(1)[0]

        def post(data, headers):
            req = urllib.request.Request(f"{url}/predict", data=data,
                                         headers=headers, method="POST")
            return json.loads(
                urllib.request.urlopen(req, timeout=120).read())

        raw = {"Content-Type": "application/octet-stream",
               "X-NIDT-Shape": "12,14,12"}
        r0 = post(json.dumps({"x": x.tolist(), "site": "0"}).encode(),
                  {"Content-Type": "application/json"})
        r1 = post(x.tobytes(), {**raw, "X-NIDT-Site": "1"})
        assert r0["model"] == "site:0" and r1["model"] == "site:1"
        assert r0["digest"] != r1["digest"]
        assert r0["model_version"] == 5
        ru = post(x.tobytes(), {**raw, "X-NIDT-Site": "9"})
        assert ru["model"] == GLOBAL_KEY
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(b"not json", {"Content-Type": "application/json"})
        assert ei.value.code == 400
        h = json.loads(urllib.request.urlopen(f"{url}/healthz",
                                              timeout=30).read())
        assert h["ok"] and h["model"] == "3dcnn_tiny"
        assert h["model_version"] == 5 and h["precision"] == "bf16"
    finally:
        audit = srv.stop()
    assert audit["reconciled"], audit
    assert audit["served"] == 3 and audit["rejected"] == 1, audit
    assert audit["unknown_site"] == 1, audit
    # each worker's final telemetry reached the merged exposition
    text = srv.metrics_view().prometheus_text()
    for w in ("0", "1"):
        assert f'nidt_obs_worker_alive{{worker="{w}"}}' in text
    assert "nidt_serve_requests_total{" in text


def test_worker_on_missing_card_fails_startup(ditto_bundles):
    """A fleet asked for ``cuda`` (the default) without a card fails at
    startup with a named error: no worker serves on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from neuroimagedisttraining_tpu_torch.serve.server import (
        ShardedServeServer,
    )

    with pytest.raises(RuntimeError, match="died during startup"):
        ShardedServeServer(ditto_bundles["bf16"], serve_workers=1,
                           batch_buckets=(1,), spawn_timeout=120.0)
