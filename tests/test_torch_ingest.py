"""The port's sharded ingest plane (``neuroimagedisttraining_tpu_torch/
asyncfl/ingest.py``) against the reference package's, on the same numpy
inputs.

- ``PartialAccumulator`` totals, dense (the int64 lattice) and secure (the
  ``SlotAccumulator`` chunk fold), ``array_equal`` to the reference's; the
  merge of any partition equal to one fold, bit for bit (the reference's
  partitions); NaN and saturation folded as the reference folds them.
- A worker's admission verdicts equal to the reference worker's on one
  event sequence, and its exported partial's totals equal; a worker's
  modules and work import no torch.
- The CLI: ``run.py --async_server --ingest_workers 2 --ingest_shm
  --sync_delta`` on ``3dcnn_tiny`` with 3 silo processes on the CPU: the
  reference's key set, a green audit, delta syncs sent, and each upload's
  trace flow linked from its silo through a worker to the root's merge.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from neuroimagedisttraining_tpu.asyncfl import ingest as RI
from neuroimagedisttraining_tpu.distributed import message as RM
from neuroimagedisttraining_tpu.privacy import QuantSpec as RQuant
from neuroimagedisttraining_tpu.privacy import (
    encode_secure_quant as r_encode,
)
from neuroimagedisttraining_tpu_torch.asyncfl import ingest as PI
from neuroimagedisttraining_tpu_torch.asyncfl.loadgen import (
    canned_update_tree,
)
from neuroimagedisttraining_tpu_torch.distributed import message as M
from neuroimagedisttraining_tpu_torch.distributed.ports import (
    free_port_block,
)
from neuroimagedisttraining_tpu_torch.privacy import QuantSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIKE = canned_update_tree(0, 64)


def _dense_entries(n, leaf_elems=64):
    return [(canned_update_tree(r, leaf_elems), 100 + 7 * r)
            for r in range(1, n + 1)]


def _secure_entries(n, leaf_elems=64):
    quant = RQuant.from_bits(32, 10, 3)
    return [(r_encode(canned_update_tree(r, leaf_elems), 1.0, quant,
                      np.random.default_rng(r)), 200 + 11 * r)
            for r in range(1, n + 1)]


def _specs(secure: bool):
    if secure:
        return (PI.make_fold_spec(LIKE, quant=QuantSpec.from_bits(32, 10, 3)),
                RI.make_fold_spec(LIKE, quant=RQuant.from_bits(32, 10, 3)))
    return PI.make_fold_spec(LIKE), RI.make_fold_spec(LIKE)


def _merge_partition(mod, entries, spec, parts):
    merged = mod.PartialAccumulator(spec, mod.model_sizes(LIKE))
    i = 0
    for n in parts:
        acc = mod.PartialAccumulator(spec, mod.model_sizes(LIKE))
        for payload, w in entries[i:i + n]:
            if spec.quant is not None:
                acc.fold_frame(payload, w)
            else:
                acc.fold_dense(payload, w)
        i += n
        p = acc.export()
        if p is not None:
            merged.merge_payload(p)
    return merged


def test_fold_spec_equals_reference():
    for secure in (False, True):
        ours, theirs = _specs(secure)
        for f in ("frac_bits", "weight_frac_bits", "value_bound",
                  "weight_ref", "weight_cap"):
            assert getattr(ours, f) == getattr(theirs, f), f
        assert (ours.q_max, ours.mass_bound()) == \
            (theirs.q_max, theirs.mass_bound())
        for n, tau, alpha in ((8.0, 0, 0.5), (16.0, 3, 0.5), (1e-6, 0, 1.0),
                              (1e9, 0, 0.0)):
            assert ours.weight_int(n, tau, alpha) == \
                theirs.weight_int(n, tau, alpha)
    with pytest.raises(ValueError, match="field too small"):
        PI.make_fold_spec(LIKE, quant=QuantSpec.from_bits(16, 10, 3))


@pytest.mark.parametrize("secure,parts", [
    (False, [12]), (False, [4, 4, 4]), (False, [1, 11]), (False, [6, 3, 3]),
    (False, [2, 2, 2, 2, 2, 2]), (True, [9]), (True, [3, 3, 3]),
    (True, [1, 8]), (True, [5, 2, 2])])
def test_merge_partition_independent_and_equal_to_reference(secure, parts):
    """Any partition of the uploads into worker partials, merged, is the
    single-process fold bit for bit, and its totals and model are the
    reference's."""
    ours_spec, ref_spec = _specs(secure)
    entries = _secure_entries(9) if secure else _dense_entries(12)
    ref = RI.single_process_fold(entries, ref_spec, LIKE).export()
    one = PI.single_process_fold(entries, ours_spec, LIKE).export()
    merged = _merge_partition(PI, entries, ours_spec, parts)
    assert merged.w_int_total == one["w_int"] == ref["w_int"]
    assert merged.count == one["count"] == ref["count"]
    for name, _ in PI.model_sizes(LIKE):
        np.testing.assert_array_equal(merged.totals[name],
                                      one["slots"][name])
        np.testing.assert_array_equal(one["slots"][name],
                                      ref["slots"][name])
    if not secure:
        want = RI.single_process_fold(entries, ref_spec, LIKE
                                      ).finalize(LIKE)
        got = merged.finalize(LIKE)
        for k in ("kernel", "bias"):
            a = got["params"]["dense"][k]
            b = np.asarray(want["params"]["dense"][k])
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_dense_fold_nan_and_saturation_as_reference():
    bad = canned_update_tree(1, 64)
    k = bad["params"]["dense"]["kernel"]
    k[0], k[1], k[2] = np.nan, np.inf, -np.inf
    k[3] = 1e9  # past the value bound: saturates
    (ours_spec, ref_spec) = _specs(False)
    ours = PI.PartialAccumulator(ours_spec, PI.model_sizes(LIKE))
    theirs = RI.PartialAccumulator(ref_spec, RI.model_sizes(LIKE))
    ours.fold_dense(bad, 3)
    theirs.fold_dense(bad, 3)
    t = ours.totals["params/dense/kernel"]
    assert t[0] == 0
    assert t[1] == 3 * ours_spec.q_max == -t[2] == t[3]
    for name, _ in PI.model_sizes(LIKE):
        np.testing.assert_array_equal(ours.totals[name],
                                      theirs.totals[name])


def _upload(mod, c, tag=None, n=8.0, seq=None, tree=None):
    msg = mod.Message(mod.MSG_TYPE_C2S_SEND_MODEL, c, 0)
    msg.add(mod.ARG_MODEL_PARAMS,
            tree if tree is not None else canned_update_tree(c, 64))
    msg.add(mod.ARG_NUM_SAMPLES, n)
    if tag is not None:
        msg.add(mod.ARG_ROUND_IDX, tag)
    if seq is not None:
        msg.add(mod.ARG_UPLOAD_SEQ, seq)
    return msg


def _events():
    """One worker's event sequence: ``("up", kwargs)``, ``("model",
    version, tree)``, ``("reg", c)``, ``("done",)``."""
    bad = canned_update_tree(3, 64)
    bad["params"]["dense"]["bias"][0] = np.nan
    return [
        ("up", dict(c=1, tag=0, seq=0)),
        ("up", dict(c=1, tag=0, seq=0)),             # re-delivered
        ("up", dict(c=1, tag=0, seq=1)),
        ("up", dict(c=2, tag=7, seq=0)),             # future
        ("up", dict(c=4)),                           # no seq: legacy dedup
        ("up", dict(c=4)),
        ("model", 3, canned_update_tree(97, 64)),
        ("up", dict(c=2, tag=1, seq=1, n=16.0)),     # tau 2
        ("model", 6, canned_update_tree(99, 64)),
        ("up", dict(c=2, tag=1, seq=2)),             # ancient
        ("up", dict(c=3, tag=6, seq=0, tree=bad)),   # non-finite
        ("up", dict(c=5, tag=6, seq=0, n=float("nan"))),  # malformed
        ("reg", 4),
        ("up", dict(c=4, tag=3)),                    # tau 3 after re-reg
        ("done",),
        ("up", dict(c=1, tag=6, seq=3)),
    ]


def test_worker_admission_verdicts_equal_reference():
    cores = [mod.IngestWorkerCore(0, spec, LIKE, max_staleness=4,
                                  staleness_alpha=0.5)
             for mod, spec in zip((PI, RI), _specs(False))]
    verdicts = []
    for ev in _events():
        if ev[0] == "up":
            got = [core.handle_upload(_upload(mod, **ev[1]))
                   for core, mod in zip(cores, (M, RM))]
            assert got[0] == got[1], ev
            verdicts.append(got[0])
        elif ev[0] == "model":
            for core in cores:
                core.set_model(ev[1], ev[2])
        elif ev[0] == "reg":
            assert cores[0].handle_register(ev[1]) == \
                cores[1].handle_register(ev[1])
        else:
            for core in cores:
                core.done = True
    assert set(verdicts) == {
        "accepted", "dropped_duplicate", "dropped_future", "dropped_stale",
        "dropped_nonfinite", "dropped_malformed", "dropped_after_done"}
    assert cores[0].stats == cores[1].stats
    ours, theirs = (core.export_partial() for core in cores)
    assert [e[:6] for e in ours["entries"]] == \
        [e[:6] for e in theirs["entries"]]
    assert (ours["w_int"], ours["count"]) == \
        (theirs["w_int"], theirs["count"])
    for name in theirs["slots"]:
        np.testing.assert_array_equal(ours["slots"][name],
                                      theirs["slots"][name])


def test_worker_secure_frame_gate_as_reference():
    from neuroimagedisttraining_tpu_torch.privacy import encode_secure_quant

    quant = QuantSpec.from_bits(32, 10, 3)
    core = PI.IngestWorkerCore(0, PI.make_fold_spec(LIKE, quant=quant),
                               LIKE, max_staleness=4, staleness_alpha=0.5)
    frame = encode_secure_quant(canned_update_tree(1, 64), 1.0, quant,
                                np.random.default_rng(0))
    assert core.handle_upload(_upload(M, 1, 0, seq=0, tree=frame)) == \
        "accepted"
    assert core.handle_upload(_upload(M, 2, 0, seq=0)) == \
        "dropped_undecodable"
    other = encode_secure_quant(canned_update_tree(3, 64), 1.0,
                                QuantSpec.from_bits(32, 8, 3),
                                np.random.default_rng(1))
    assert core.handle_upload(_upload(M, 3, 0, seq=0, tree=other)) == \
        "dropped_undecodable"


def test_root_refuses_defenses_as_reference():
    with pytest.raises(ValueError, match="defenses") as ours:
        PI.ShardedIngestServer(LIKE, 2, 4, ingest_workers=1,
                               defense="trimmed_mean", device="cpu")
    with pytest.raises(ValueError, match="defenses") as theirs:
        RI.ShardedIngestServer(LIKE, 2, 4, ingest_workers=1,
                               defense="trimmed_mean")
    assert str(ours.value) == str(theirs.value)


def test_worker_path_imports_no_torch():
    """A worker's modules, its admission, fold and delta sync (dense and
    secure) run in a process that never imports torch: the workers and
    regions are host code, spawned quickly and with no CUDA context."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from neuroimagedisttraining_tpu_torch.asyncfl import ingest, region
        from neuroimagedisttraining_tpu_torch.distributed import message as M
        from neuroimagedisttraining_tpu_torch.privacy import (
            QuantSpec, encode_secure_quant)
        like = {"params": {"w": np.zeros(8, np.float32)}}
        def up(tree):
            m = M.Message(M.MSG_TYPE_C2S_SEND_MODEL, 1, 0)
            m.add(M.ARG_MODEL_PARAMS, tree)
            m.add(M.ARG_NUM_SAMPLES, 4.0)
            m.add(M.ARG_ROUND_IDX, 0)
            return M.Message.from_bytes(m.to_bytes())
        q = QuantSpec.from_bits(32, 10, 3)
        for quant, tree in ((None, {"params": {"w": np.ones(8, np.float32)}}),
                            (q, encode_secure_quant(
                                {"params": {"w": np.ones(8, np.float32)}},
                                1.0, q, np.random.default_rng(0)))):
            core = ingest.IngestWorkerCore(
                0, ingest.make_fold_spec(like, quant=quant), like,
                max_staleness=4, staleness_alpha=0.5)
            assert core.handle_upload(up(tree)) == "accepted"
            assert core.export_partial()["count"] == 1
        core.handle_register(1, incarnation=3, delta_ok=True)
        core.last_synced[1] = 0
        core.set_model(1, {"params": {"w": np.full(8, 2.0, np.float32)}})
        assert core.build_sync_body(1)[1] == "delta"
        assert "torch" not in sys.modules, "a worker imported torch"
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


# ----------------------------------------------------------------- the CLI

def test_cli_ingest_workers_three_silo_processes(tmp_path):
    """Server (2 ingest workers, shm hand-off, delta syncs) and 3 silos as
    OS processes on the CPU. The silos start first and the server after
    them, so they join it within half a second of each other."""
    from test_torch_distributed import _reference_key_set

    bp = free_port_block(8)
    common = ["--num_clients", "3", "--comm_round", "3",
              "--model", "3dcnn_tiny", "--dataset", "synthetic",
              "--synthetic_num_subjects", "24",
              "--synthetic_shape", "12", "14", "12",
              "--batch_size", "4", "--base_port", str(bp),
              "--device", "cpu", "--async_server", "--ingest_workers", "2",
              "--ingest_shm", "--sync_delta"]
    cmd = [sys.executable, "-m",
           "neuroimagedisttraining_tpu_torch.distributed.run"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}

    def start(role, trace):
        return subprocess.Popen(cmd + role + common + ["--trace_out",
                                                       str(trace)],
                                stdout=subprocess.PIPE, text=True,
                                cwd=REPO, env=env)

    procs = [start(["--role", "client", "--rank", str(r)],
                   tmp_path / f"silo{r}.json") for r in (1, 2, 3)]
    try:
        for p in procs:  # each silo has built its shard and model
            while "joining server" not in p.stdout.readline():
                assert p.poll() is None
        procs.insert(0, start(["--role", "server"], tmp_path / "root.json"))
        outs = [p.communicate(timeout=120)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the federation did not finish: " + " | ".join(
            (p.communicate()[0] or "")[-600:] for p in procs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0, 0, 0], outs
    lines = [[json.loads(ln) for ln in o.splitlines() if ln.startswith("{")]
             for o in outs]
    res = lines[0][-1]
    assert set(res) == _reference_key_set(
        ("health", "health_timeline", "actions", "async_server", "buffer_k",
         "staleness_alpha", "max_staleness", "upload_audit",
         "staleness_taus", "ingest_workers", "worker_xstats"))
    audit = res["upload_audit"]
    assert audit["received_accounted"] and audit["accepted_accounted"]
    assert res["rounds_completed"] == 3 and audit["lost_with_worker"] == 0
    assert res["worker_xstats"]["sync_delta_sent"] > 0
    assert res["worker_xstats"]["shm_exports"] > 0
    assert res["final_param_norm"] > 0
    stages = lines[0][-2]["upload_stage_ms"]
    assert stages["fold"]["count"] == audit["accepted"]
    assert sum(s[-1]["rounds_trained"] for s in lines[1:]) >= \
        audit["received"]
    from neuroimagedisttraining_tpu_torch.obs import fanin

    events = []
    for name in ("root", "silo1", "silo2", "silo3"):
        events += json.load(open(tmp_path / f"{name}.json"))["traceEvents"]
    flows = fanin.linked_flow_ids(events)
    assert flows["linked"], {k: len(v) for k, v in flows.items()}
