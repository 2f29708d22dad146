"""The port's hierarchical tier (``neuroimagedisttraining_tpu_torch/asyncfl/
region.py``), the shared-memory partial hand-off and the workers' delta
syncs, against the reference package's on the same numpy inputs.

- Any (region x worker) tree of partials, merged, is the single-root fold
  bit for bit, and the reference's, dense and secure.
- A partial through a shared-memory slab reads back bit for bit, NaN and
  saturation encodings included, across the two packages' slab classes; a
  torn read raises; the owner's teardown unlinks the segment.
- A worker's delta sync decodes bit for bit to its dense reply; a base
  that left the ring falls back to dense, logged and counted.
- A forced migration's replayed upload is a duplicate, not counted twice.
- A live tree on the CPU, 3 silos as threads: 2 regions of 1 worker with
  a tiny model, and 2 regions of 2 workers with partials of 8 MB (a model
  broadcast meeting a partial in flight); the audit green with the
  per-region table.
"""

import logging
import threading

import numpy as np
import pytest

from neuroimagedisttraining_tpu.asyncfl import ingest as RI
from neuroimagedisttraining_tpu.privacy import QuantSpec as RQuant
from neuroimagedisttraining_tpu.privacy import (
    encode_secure_quant as r_encode,
)
from neuroimagedisttraining_tpu_torch.asyncfl import ingest as PI
from neuroimagedisttraining_tpu_torch.asyncfl.loadgen import (
    canned_update_tree,
)
from neuroimagedisttraining_tpu_torch.codec import wire
from neuroimagedisttraining_tpu_torch.distributed import message as M
from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (
    named_leaves,
)
from neuroimagedisttraining_tpu_torch.privacy import QuantSpec

LIKE = canned_update_tree(0, 64)

TOPOLOGIES = [
    [[12]],                      # 1 region x 1 worker
    [[6], [6]],                  # 2 regions x 1 worker
    [[3, 3], [3, 3]],            # 2 regions x 2 workers
    [[4, 2], [1, 5]],            # ragged loads
    [[2, 2], [2, 2], [2, 2]],    # 3 regions x 2 workers
]


def _merge_tree(entries, spec, topology):
    """Workers fold their slices, each region merges its workers'
    partials, the root merges the regions' in region-id order."""
    root = PI.PartialAccumulator(spec, PI.model_sizes(LIKE))
    i = 0
    for region_workers in topology:
        region = PI.PartialAccumulator(spec, PI.model_sizes(LIKE))
        for n in region_workers:
            worker = PI.PartialAccumulator(spec, PI.model_sizes(LIKE))
            for payload, w in entries[i:i + n]:
                if spec.quant is not None:
                    worker.fold_frame(payload, w)
                else:
                    worker.fold_dense(payload, w)
            i += n
            p = worker.export()
            if p is not None:
                region.merge_payload(p)
        p = region.export()
        if p is not None:
            root.merge_payload(p)
    assert i == len(entries)
    return root


@pytest.mark.parametrize("secure", [False, True])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_tree_merge_equals_single_root_and_reference(topology, secure):
    if secure:
        rq = RQuant.from_bits(32, 10, 3)
        entries = [(r_encode(canned_update_tree(r, 64), 1.0, rq,
                             np.random.default_rng(r)), 200 + 11 * r)
                   for r in range(1, 13)]
        spec = PI.make_fold_spec(LIKE, quant=QuantSpec.from_bits(32, 10, 3))
        rspec = RI.make_fold_spec(LIKE, quant=rq)
    else:
        entries = [(canned_update_tree(r, 64), 100 + 7 * r)
                   for r in range(1, 13)]
        spec, rspec = PI.make_fold_spec(LIKE), RI.make_fold_spec(LIKE)
    one = PI.single_process_fold(entries, spec, LIKE).export()
    ref = RI.single_process_fold(entries, rspec, LIKE).export()
    merged = _merge_tree(entries, spec, topology)
    assert merged.w_int_total == one["w_int"] == ref["w_int"]
    assert merged.count == one["count"] == ref["count"]
    for name, _ in PI.model_sizes(LIKE):
        np.testing.assert_array_equal(merged.totals[name],
                                      one["slots"][name])
        np.testing.assert_array_equal(one["slots"][name],
                                      ref["slots"][name])


@pytest.mark.parametrize("writer_mod,reader_mod",
                         [(PI, PI), (PI, RI), (RI, PI)])
def test_shm_slab_roundtrip_bitwise_with_edge_encodings(writer_mod,
                                                        reader_mod):
    spec = PI.make_fold_spec(LIKE)
    bad = canned_update_tree(1, 64)
    k = bad["params"]["dense"]["kernel"]
    k[0], k[1], k[2] = np.nan, np.inf, -np.inf
    acc = PI.PartialAccumulator(spec, PI.model_sizes(LIKE))
    acc.fold_dense(bad, 3)
    payload = acc.export()
    segs = [payload["slots"][name] for name, _ in PI.model_sizes(LIKE)]
    total = sum(s.size for s in segs)
    t = acc.totals["params/dense/kernel"]
    assert t[0] == 0 and t[1] == 3 * spec.q_max == -t[2]

    writer = writer_mod._ShmSlabWriter(total)
    reader = reader_mod._ShmSlabReader(writer.name, total)
    try:
        gen = writer.write(segs, payload["w_int"], payload["count"])
        flat, w_int, count = reader.read(gen)
        np.testing.assert_array_equal(flat, np.concatenate(segs))
        assert (w_int, count) == (payload["w_int"], payload["count"])
        # a second write without the ack: the old generation is a torn read
        writer.write(segs, 1, 1)
        with pytest.raises(RuntimeError, match="torn read"):
            reader.read(gen)
    finally:
        reader.close()
        writer.destroy()
    with pytest.raises(FileNotFoundError):
        PI._ShmSlabReader(writer.name, total)


def _core(mod=PI, wid=0, max_staleness=4):
    spec = mod.make_fold_spec(LIKE)
    return mod.IngestWorkerCore(wid, spec, LIKE, max_staleness=max_staleness,
                                staleness_alpha=0.5)


def test_delta_sync_reply_decodes_bitwise_and_equals_reference():
    cores = [_core(PI), _core(RI)]
    frames = []
    for core in cores:
        core.handle_register(1, incarnation=9, delta_ok=True)
        core.handle_register(2, incarnation=9, delta_ok=False)
        core.last_synced[1] = core.last_synced[2] = 0
        core.set_model(1, canned_update_tree(42, 64))
        dense, kind = core.build_sync_body(2)
        assert kind == "dense"
        frame, kind = core.build_sync_body(1)
        assert kind == "delta" and int(frame["base"]) == 0
        assert core.build_sync_body(1)[0] is frame  # one encode a pair
        frames.append(frame)
        assert core.sync_stats == {"sync_delta_sent": 2,
                                   "sync_dense_sent": 1,
                                   "sync_dense_fallback_ring": 0}
    assert wire.msgpack_dumps(frames[0]) == wire.msgpack_dumps(frames[1])
    decoded = wire.decode_sync_delta(frames[0], LIKE)
    want = named_leaves(cores[0].params)
    for name, x in named_leaves(decoded).items():
        assert x.tobytes() == want[name].tobytes()


def test_delta_sync_base_off_ring_falls_back_dense_logged(caplog):
    core = _core(max_staleness=2)
    core.handle_register(1, incarnation=9, delta_ok=True)
    core.last_synced[1] = 0
    for v in (1, 2, 3, 4):
        core.set_model(v, canned_update_tree(v, 64))
    assert 0 not in core._ring
    with caplog.at_level(logging.INFO,
                         logger="neuroimagedisttraining_tpu_torch.asyncfl"):
        body, kind = core.build_sync_body(1)
    assert kind == "dense_fallback_ring" and body is core.params
    assert core.sync_stats["sync_dense_fallback_ring"] == 1
    assert any("left the broadcast ring" in r.message
               for r in caplog.records)


def _upload(c, tag, seq, n=8.0):
    msg = M.Message(M.MSG_TYPE_C2S_SEND_MODEL, c, 0)
    msg.add(M.ARG_MODEL_PARAMS, canned_update_tree(c, 64))
    msg.add(M.ARG_NUM_SAMPLES, n)
    msg.add(M.ARG_ROUND_IDX, tag)
    msg.add(M.ARG_UPLOAD_SEQ, seq)
    return msg


def test_forced_migration_replay_is_duplicate_not_double_count():
    """Worker A accepts seqs 0..2 of silo 7 and dies; the silo reconnects
    to worker B with the same incarnation and re-sends seq 2: the root's
    floor makes it a duplicate. A new incarnation restarts at seq 0."""
    wm = PI.SeqWatermarks()
    a, b = _core(wid=0), _core(wid=1)
    c, inc = 7, 3
    assert wm.register(c, inc) == -1
    a.handle_register(c, incarnation=inc)
    a.note_seqfloor(c, inc, -1)
    for s in range(3):
        assert a.handle_upload(_upload(c, 0, s)) == "accepted"
    wm.advance(c, inc, 2)
    floor = wm.register(c, inc)
    assert floor == 2
    b.handle_register(c, incarnation=inc)
    b.note_seqfloor(c, inc, floor)
    assert b.handle_upload(_upload(c, 0, 2)) == "dropped_duplicate"
    assert b.handle_upload(_upload(c, 0, 3)) == "accepted"
    assert wm.register(c, inc + 1) == -1
    b.handle_register(c, incarnation=inc + 1)
    b.note_seqfloor(c, inc + 1, wm.register(c, inc + 1))
    b.note_seqfloor(c, inc, 99)  # a superseded incarnation's floor
    assert b.handle_upload(_upload(c, 0, 0)) == "accepted"
    wm.advance(c, inc, 50)
    assert wm.floor(c, inc + 1) == -1
    wm.advance(c, inc + 1, 0)
    assert wm.floor(c, inc + 1) == 0
    # the reference's table answers the same calls alike
    tables = PI.SeqWatermarks(), RI.SeqWatermarks()
    for call in (("register", c, inc), ("advance", c, inc, 2),
                 ("register", c, inc), ("floor", c, inc),
                 ("register", c, inc + 1), ("advance", c, inc, 50),
                 ("floor", c, inc + 1), ("advance", c, inc + 1, 0),
                 ("floor", c, inc + 1), ("floor", c, inc)):
        assert getattr(tables[0], call[0])(*call[1:]) == \
            getattr(tables[1], call[0])(*call[1:]), call


@pytest.mark.parametrize("leaf,workers_per_region,flush,use_shm", [
    (64, 1, 0.25, True),
    # partials of 8 MB on the pipe: a region's model broadcast meets a
    # worker's headroom partial in flight (the two deadlocked when the
    # region's one loop wrote its workers' pipes itself)
    (1_000_000, 2, 0.02, False)])
def test_region_tree_on_the_cpu_audits_green(leaf, workers_per_region,
                                             flush, use_shm):
    from neuroimagedisttraining_tpu_torch.asyncfl.loop import (
        PersistentClientCommManager,
    )
    from neuroimagedisttraining_tpu_torch.asyncfl.region import (
        HierarchicalIngestServer,
    )
    from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (
        FedAvgClientProc,
    )
    from neuroimagedisttraining_tpu_torch.distributed.ports import (
        free_port_block,
    )

    like = canned_update_tree(0, leaf)
    port = free_port_block(8)
    srv = HierarchicalIngestServer(like, 3, 3, regions=2,
                                   workers_per_region=workers_per_region,
                                   buffer_k=3, base_port=port,
                                   flush_interval=flush, use_shm=use_shm,
                                   sync_delta=True, device="cpu")

    def train_fn(params, round_idx):
        return wire.nest({k: v + np.float32(0.01)
                          for k, v in named_leaves(params).items()}), 8.0

    silos = [FedAvgClientProc(r, 3, train_fn, sync_delta=True, device="cpu",
                              comm=PersistentClientCommManager(
                                  r, 4, base_port=port)) for r in (1, 2, 3)]
    threads = [threading.Thread(target=s.run, daemon=True) for s in silos]
    for t in threads:
        t.start()
    st = threading.Thread(target=srv.run, daemon=True)
    st.start()
    st.join(60)
    assert srv._done.is_set(), srv.history
    audit = srv.upload_audit()
    assert audit["received_accounted"] and audit["accepted_accounted"]
    assert srv.round_idx == 3 and audit["lost_with_region"] == 0
    assert sorted(audit["regions"]) == [0, 1]
    for t in threads:
        t.join(10)
    assert all(np.isfinite(x).all() for x in named_leaves(srv.params).values())
