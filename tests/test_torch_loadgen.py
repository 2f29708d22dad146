"""The port's load harness (``neuroimagedisttraining_tpu_torch/asyncfl/
loadgen.py``) against the reference package's, on the CPU.

- The payloads (``canned_update_tree``, ``bench_payload`` plain and
  secure-quant, ``_local_update_tree``) bit-equal to the reference's for 3
  ranks and 2 seeds, and an upload's ``_frame`` byte-equal.
- ``_staleness_hist`` and ``_merge_serve_stats`` equal to the reference's
  on the same inputs.
- ``run_load`` in ``async`` and ``sync`` (8 clients, 2 aggregations,
  ``device="cpu"``): the reference's result key set, the audits green;
  the reference's permanent-crash case; an ingest run with 2 workers, shm
  and delta syncs.
- A fleet client imports no torch; ``main()`` prints its cells and
  summary and writes nothing without ``--out``, reading no
  ``bench_matrix/`` file.
- Marked ``slow`` as the reference marks its own: the 200-client churn,
  the ingest and region end-to-end runs and the serve fleet.
"""

import builtins
import dataclasses
import io
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

from neuroimagedisttraining_tpu.asyncfl import loadgen as R
from neuroimagedisttraining_tpu.distributed import message as RM
from neuroimagedisttraining_tpu.privacy import QuantSpec as RQuant
from neuroimagedisttraining_tpu_torch.asyncfl import loadgen as L
from neuroimagedisttraining_tpu_torch.distributed import message as M
from neuroimagedisttraining_tpu_torch.privacy import QuantSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert la[k].shape == lb[k].shape, k
        assert la[k].tobytes() == lb[k].tobytes(), k


def _upload(mod, rank, payload, version, seq):
    """The upload ``_run_client`` sends, built in either package."""
    msg = mod.Message(mod.MSG_TYPE_C2S_SEND_MODEL, rank, 0)
    msg.add(mod.ARG_MODEL_PARAMS, payload)
    msg.add(mod.ARG_NUM_SAMPLES, float(8 + rank % 5))
    msg.add(mod.ARG_ROUND_IDX, version)
    msg.add(mod.ARG_UPLOAD_SEQ, seq)
    msg.add(mod.ARG_TRACE_CTX, {"trace_id": (rank << 24) | seq,
                                "span_id": rank})
    return msg


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("rank", [1, 2, 7])
def test_payloads_and_frames_equal_reference(rank, seed):
    leaf = 96 + 16 * rank
    _bit_equal(L.canned_update_tree(rank, leaf),
               R.canned_update_tree(rank, leaf))
    plain = L.bench_payload(rank, leaf, None, seed)
    _bit_equal(plain, R.bench_payload(rank, leaf, None, seed))
    secure = L.bench_payload(rank, leaf, QuantSpec.from_bits(32, 10, 3),
                             seed)
    _bit_equal(secure, R.bench_payload(rank, leaf,
                                       RQuant.from_bits(32, 10, 3), seed))
    base = L.canned_update_tree(100 + seed, leaf)
    _bit_equal(L._local_update_tree(base, plain, 0.01),
               R._local_update_tree(base, plain, 0.01))
    for payload in (plain, secure):
        assert L._frame(_upload(M, rank, payload, 3, seed)) == \
            R._frame(_upload(RM, rank, payload, 3, seed))


def test_staleness_hist_and_serve_merge_equal_reference():
    history = [{"taus": [0, 0, 1]}, {"taus": [2, 0]}, {}, {"taus": [11]}]
    assert L._staleness_hist(history) == R._staleness_hist(history)
    rng = np.random.default_rng(3)
    ours, theirs = [], []
    for i in range(4):
        kw = dict(sent=int(rng.integers(10)), ok=int(rng.integers(10)),
                  rejected=i, errors=i % 2, reconnects=i // 2,
                  rtt_ms=list(rng.random(3)),
                  routes={"0": {"d0": i + 1}, str(i % 2): {f"d{i}": 2}})
        ours.append(L.ServeClientStats(**kw))
        theirs.append(R.ServeClientStats(**json.loads(json.dumps(kw))))
    assert dataclasses.asdict(L._merge_serve_stats(ours)) == \
        dataclasses.asdict(R._merge_serve_stats(theirs))


def _green(res):
    audit = res["upload_audit"]
    assert audit["received_accounted"], audit
    assert audit["accepted_accounted"], audit
    assert res["frames_reconciled"], res
    assert res["rounds_or_aggregations"] == res["target"], res


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_run_load_keys_equal_reference(mode):
    kw = dict(num_clients=8, aggregations=2, buffer_k=4, leaf_elems=64,
              seed=1)
    ours = L.run_load(mode, device="cpu", **kw)
    theirs = R.run_load(mode, **kw)
    assert ours.keys() == theirs.keys()
    for key in ("client_stats", "upload_audit", "byte_stats"):
        assert ours[key].keys() == theirs[key].keys(), key
    _green(ours)
    _green(theirs)
    assert ours["mode"] == mode and ours["num_clients"] == 8


def test_loadgen_cohort_buffer_survives_permanent_crash():
    """buffer_k=0 (cohort-sized) plus one PERMANENT crash must not hang
    the harness: the corpse report shrinks the effective threshold (the
    reference's case, against the port)."""
    r = L.run_load(mode="async", num_clients=8, aggregations=4,
                   buffer_k=0, fault_spec="crash:3@1", seed=2, device="cpu")
    assert r["rounds_or_aggregations"] == 4
    assert r["frames_reconciled"], r
    assert r["client_stats"]["crashes"] == 1


def test_ingest_two_workers_shm_delta():
    res = L.run_load(mode="ingest", num_clients=8, aggregations=2,
                     buffer_k=4, ingest_workers=2, ingest_shm=True,
                     sync_delta=True, upload_local_scale=1e-6,
                     leaf_elems=64, device="cpu")
    _green(res)
    assert res["client_stats"]["delta_errors"] == 0
    assert res["lost_with_worker"] == 0
    assert res["workers_live_at_end"] == []
    assert res["ingest_shm"] is True and res["sync_delta"] is True


def test_fleet_client_imports_no_torch():
    """A fleet client (``_run_client`` with its payloads, plain and
    secure) runs in a process that never imports torch: the fleet shards
    start fast and never touch the card."""
    from neuroimagedisttraining_tpu_torch.asyncfl.loop import (
        SelectorCommManager,
    )
    from neuroimagedisttraining_tpu_torch.asyncfl.server import (
        BufferedFedAvgServer,
    )
    from neuroimagedisttraining_tpu_torch.distributed.ports import (
        free_port_block,
    )

    port = free_port_block(2)
    comm = SelectorCommManager(0, 3, base_port=port, send_timeout=2.0)
    srv = BufferedFedAvgServer(L.canned_update_tree(0, 64), 2, 2,
                               buffer_k=2, comm=comm, device="cpu")
    t = threading.Thread(target=srv.run, daemon=True)
    t.start()
    code = textwrap.dedent(f"""
        import asyncio, sys
        from neuroimagedisttraining_tpu_torch.asyncfl import loadgen as L
        from neuroimagedisttraining_tpu_torch.privacy import QuantSpec
        L.bench_payload(3, 64, QuantSpec.from_bits(32, 10, 3), 0)
        stats = {{r: L.ClientStats() for r in (1, 2)}}

        async def fleet():
            await asyncio.gather(*[L._run_client(
                r, {port}, L.bench_payload(r, 64, None, 0), 8.0, stats[r],
                None, lambda: -1, lambda: False, 0.0, 0.0)
                for r in (1, 2)])

        asyncio.run(fleet())
        print(sum(s.sent for s in stats.values()),
              sum(s.finished for s in stats.values()),
              "torch" in sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    t.join(timeout=30)
    assert out.returncode == 0, out.stderr
    sent, finished, torch_in = out.stdout.split()
    assert int(sent) >= 4 and int(finished) == 2
    assert torch_in == "False"
    assert len(srv.history) == 2


def test_main_both_prints_cells_and_writes_nothing(tmp_path, monkeypatch):
    opened = []
    real_open = builtins.open

    def spy(file, *a, **kw):
        opened.append(str(file))
        return real_open(file, *a, **kw)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(builtins, "open", spy)
    buf = io.StringIO()
    monkeypatch.setattr(sys, "stdout", buf)
    rc = L.main(["--clients", "8", "--mode", "both", "--aggregations", "2",
                 "--buffer_k", "4", "--leaf_elems", "64", "--device",
                 "cpu"])
    monkeypatch.undo()
    assert rc == 0
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
             if ln.startswith("{")]
    assert [ln.get("mode") for ln in lines[:2]] == ["async", "sync"]
    assert set(lines[2]["summary"]) == {"uploads_per_s_ratio",
                                        "p99_advance_ratio"}
    assert os.listdir(tmp_path) == []
    assert not [p for p in opened if "bench_matrix" in p]


# ---------------------------------------------------------------------------
# slow: the reference's slow load-harness cases, against the port
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_loadgen_200_clients_with_churn_smoke():
    r = L.run_load(mode="async", num_clients=200, aggregations=10,
                   buffer_k=40, max_staleness=50,
                   fault_spec="crash:7@2,rejoin:7@6,crash:11@3", seed=3,
                   device="cpu")
    assert r["rounds_or_aggregations"] == 10
    assert r["peak_connections"] >= 200
    assert r["frames_reconciled"], r
    assert r["client_stats"]["crashes"] >= 2
    assert r["client_stats"]["rejoins"] >= 1
    assert r["client_stats"]["errors"] == 0


@pytest.mark.slow
def test_ingest_two_workers_end_to_end(tmp_path):
    trace_out = str(tmp_path / "merged_trace.json")
    res = L.run_load(mode="ingest", num_clients=24, aggregations=5,
                     buffer_k=8, ingest_workers=2, leaf_elems=64,
                     trace_out=trace_out,
                     flight_out=str(tmp_path / "merged_flight.json"),
                     device="cpu")
    _green(res)
    assert res["lost_with_worker"] == 0
    assert res["workers_live_at_end"] == []
    fan = res["obs_fanin"]
    assert fan["0"]["has_metrics"] and fan["1"]["has_metrics"], fan
    assert res["merged_metrics"]["worker_labeled"] == [0, 1]
    assert res["merged_metrics"]["has_stage_samples"]
    assert res["merged_metrics"]["has_rtt_samples"]
    assert res["merged_trace"]["flow_linked"] >= 1, res["merged_trace"]
    with open(trace_out) as f:
        assert json.load(f)["traceEvents"]
    with open(tmp_path / "merged_flight.json") as f:
        assert any(e["proc"].startswith("worker")
                   for e in json.load(f)["events"])


@pytest.mark.slow
def test_ingest_kill_one_worker_audits_green():
    res = L.run_load(mode="ingest", num_clients=24, aggregations=6,
                     buffer_k=8, ingest_workers=2, ingest_kill_at=2,
                     leaf_elems=64, device="cpu")
    _green(res)
    w0 = res["upload_audit"]["workers"][0]
    assert not w0["alive"]
    assert w0["acc"] == w0["folded"]
    assert res["client_stats"]["rejoins"] >= 1
    assert res["obs_fanin"]["0"]["alive"] is False
    assert 1 in res["merged_metrics"]["worker_labeled"]


@pytest.mark.slow
def test_ingest_secure_quant_end_to_end():
    res = L.run_load(mode="ingest", num_clients=16, aggregations=4,
                     buffer_k=6, ingest_workers=2,
                     ingest_secure_quant=True, leaf_elems=64, device="cpu")
    _green(res)
    assert res["secure_quant"] is True


@pytest.mark.slow
def test_region_tree_end_to_end_shm_and_delta():
    res = L.run_load(mode="ingest", num_clients=24, aggregations=6,
                     buffer_k=8, regions=2, ingest_workers=2,
                     ingest_shm=True, sync_delta=True,
                     upload_local_scale=1e-6, leaf_elems=64, device="cpu")
    _green(res)
    assert res["regions"] == 2 and res["workers_per_region"] == 2
    assert res["lost_with_region"] == 0
    assert res["worker_xstats"]["shm_exports"] > 0
    assert res["client_stats"]["delta_syncs"] > 0
    assert res["client_stats"]["delta_errors"] == 0
    assert res["merged_metrics"]["region_labeled"] == [0, 1]
    assert res["merged_metrics"]["worker_labeled"] == [0, 1, 2, 3]


@pytest.mark.slow
def test_region_tree_secure_quant_end_to_end():
    res = L.run_load(mode="ingest", num_clients=16, aggregations=4,
                     buffer_k=6, regions=2, ingest_workers=2,
                     ingest_secure_quant=True, leaf_elems=64, device="cpu")
    _green(res)
    assert res["secure_quant"] is True
    assert res["regions"] == 2


@pytest.mark.slow
def test_loadgen_serve_fleet_end_to_end(tmp_path):
    """The serve fleet on a tiny Ditto bundle: 2 workers on the CPU, 16
    clients, 48 requests (the reference's case)."""
    import jax
    import jax.numpy as jnp

    from neuroimagedisttraining_tpu.models import create_model
    from neuroimagedisttraining_tpu.serve import bundle as jbundle
    from neuroimagedisttraining_tpu.utils.checkpoint import save_checkpoint

    shape = (12, 14, 12)
    v = create_model("3dcnn_tiny", num_classes=1).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, *shape, 1)), train=False)
    params = jax.tree.map(np.asarray, v["params"])
    bstats = jax.tree.map(np.asarray, v.get("batch_stats", {}))

    def stack(tree):
        return jax.tree.map(lambda x: np.stack(
            [x * np.float32(1.0 + 0.1 * (i + 1)) for i in range(2)]), tree)

    ck = str(tmp_path / "ck")
    save_checkpoint(ck, 5, {"params": params, "batch_stats": bstats,
                            "per_params": stack(params),
                            "per_bstats": stack(bstats)})
    bdir = str(tmp_path / "bundle")
    jbundle.build_bundle(ck, bdir, model="3dcnn_tiny", num_classes=1,
                         input_shape=shape, precision="bf16")
    res = L.run_load(mode="serve", num_clients=16, serve_bundle=bdir,
                     serve_workers=2, serve_requests=48,
                     batch_buckets=(1, 2, 4), fleet_procs=1, device="cpu")
    assert res["frames_reconciled"], res["serve_audit"]
    assert res["requests_ok"] == 48
    assert res["compile_pin_ok"], res["compiled_programs"]
    assert res["routing"]["distinct_site_models"], res["routing"]
    assert res["merged_metrics"]["worker_labeled"] == [0, 1]
    assert res["merged_metrics"]["has_serve_latency"]
    assert res["merged_metrics"]["has_rtt_samples"]
