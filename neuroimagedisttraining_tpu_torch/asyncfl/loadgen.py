"""Load harness: thousands of lightweight simulated clients, one server
(the reference package's ``asyncfl/loadgen.py``).

The point of the asynchronous control plane is a population no
thread-per-connection server can hold; this module drives one with an
asyncio client fleet — each simulated client is a coroutine holding one
persistent connection, speaking the real protocol (register ->
version-tagged sync -> upload echoing the tag), uploading a canned update
pytree instead of training. For bench cells the fleet shards across
``fleet_procs`` PROCESSES (one asyncio loop is ~a core of socket
syscalls; an unsharded generator caps near the server's own throughput
and measures itself). Churn comes from the seeded
``FaultSchedule``: ``crash:RANK@ROUND`` disconnects the client when it
observes that version, ``rejoin:RANK@ROUND`` reconnects and re-registers
once the server's version reaches the rejoin point, ``straggle:P:MAX_S``
sleeps before uploads. One ``--fault_spec`` string therefore drives the
same deterministic churn trace against both servers.

Two modes on the SAME cohort:

- ``async`` — ``BufferedFedAvgServer`` on the selector core: aggregate
  every ``buffer_k`` arrivals, staleness-weighted.
- ``sync`` — the round-synchronous ``FedAvgServer`` on the SAME selector
  core (so the A/B isolates the control-plane discipline, not the socket
  implementation), deadline + quorum armed so churn cannot deadlock the
  barrier.

Metrics per mode: sustained uploads/s (accepted), aggregations/s, p99
version-advance latency, peak concurrent connections, byte/frame
counters, and the accounting audits (every received upload accounted
exactly once; accepted == aggregated + still-buffered; sent-vs-received
reconciles to at most one in-flight upload per client).

The servers' aggregation runs on ``device`` (``cuda`` unless the caller
asks for the CPU): the buffered and synchronous servers' mean, and the
serving workers' CUDA-graph replays. The clients are host code: this
module imports no torch, the servers are imported where ``run_load``
builds them, and a spawned fleet shard never touches the card. ``main()``
prints each cell and writes the JSON only where ``--out`` names a file.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import logging
import multiprocessing as mp
import os
import signal
import struct
import threading
import time

import numpy as np

from neuroimagedisttraining_tpu_torch.distributed import message as M
from neuroimagedisttraining_tpu_torch.distributed.cross_silo import FedAvgServer
from neuroimagedisttraining_tpu_torch.distributed.ports import free_port_block
from neuroimagedisttraining_tpu_torch.faults.schedule import (
    FaultSchedule,
    parse_fault_spec,
)
from neuroimagedisttraining_tpu_torch.obs import fanin as obs_fanin
from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
from neuroimagedisttraining_tpu_torch.obs import trace as obs_trace
from neuroimagedisttraining_tpu_torch.obs import names as obs_names


log = logging.getLogger("neuroimagedisttraining_tpu_torch.asyncfl")


def canned_update_tree(rank: int, leaf_elems: int = 256) -> dict:
    """A small deterministic per-client update pytree (the model payload
    stand-in). Structure must match the server's init template."""
    rng = np.random.default_rng(9973 * rank + 17)
    return {"params": {
        "dense": {"kernel": rng.standard_normal(leaf_elems,
                                                dtype=np.float32),
                  "bias": rng.standard_normal(8, dtype=np.float32)}}}


@dataclasses.dataclass
class ClientStats:
    """Aggregated across the fleet by the harness."""

    sent: int = 0
    bytes_sent: int = 0
    syncs_seen: int = 0
    crashes: int = 0
    rejoins: int = 0
    finished: int = 0
    errors: int = 0
    #: changed-version SYNC_MODEL replies that carried a body, and the
    #: total received frame bytes of those replies — the downlink-bytes
    #: denominator/numerator of the delta-sync cell; the
    #: register bootstrap (INIT_CONFIG) is excluded: it is always dense
    #: by design, not a changed-version sync
    sync_bodies: int = 0
    sync_body_bytes: int = 0
    #: sync bodies that arrived as lossless delta frames and decoded
    #: against the client-held base
    delta_syncs: int = 0
    #: delta frames whose named base did NOT match the client-held
    #: version (protocol error — the client recovers by re-registering
    #: for a dense resync, never by applying a wrong-base delta)
    delta_errors: int = 0
    #: sampled upload->sync round-trips (ms, every 4th), fleet-merged
    #: by list concatenation in run_load's aggregation loop
    rtt_ms: list = dataclasses.field(default_factory=list)


def _frame(msg: M.Message) -> bytes:
    return M.frame_bytes(msg)


async def _read_msg(reader: asyncio.StreamReader) -> M.Message:
    header = await reader.readexactly(8)
    (length,) = struct.unpack("!Q", header)
    msg = M.Message.from_bytes(await reader.readexactly(length))
    # received wire size (header + body) — the downlink byte accounting
    # of the delta-sync cell reads it off the reply it measures
    msg.recv_len = 8 + length
    return msg


async def _connect_and_register(rank: int, port: int, server_done,
                                incarnation: int | None = None,
                                delta_ok: bool = False
                                ) -> tuple[asyncio.StreamReader,
                                           asyncio.StreamWriter] | None:
    """Connect with patience — a 1k-client connect storm can transiently
    overflow the accept backlog. Returns None once the server has
    finished (a tiny fast cohort can complete every aggregation before
    the staggered tail ever connects; retrying a closed listener
    forever would hang the fleet)."""
    delay = 0.05
    while True:
        if server_done():
            return None
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           port)
            break
        except OSError:
            await asyncio.sleep(delay)
            delay = min(1.0, delay * 2)
    reg = M.Message(M.MSG_TYPE_C2S_REGISTER, rank, 0)
    # promise a persistent connection: the selector core routes every
    # reply to this rank back on this very socket
    reg.add(M.ARG_CONN_PERSISTENT, True)
    if incarnation is not None:
        # exactly-once dedup: the SAME incarnation rides
        # every reconnect of this client process, so a post-migration
        # worker learns the root's accepted-seq floor before replying
        reg.add(M.ARG_CLIENT_INCARNATION, int(incarnation))
    if delta_ok:
        reg.add(M.ARG_SYNC_DELTA_OK, True)
    writer.write(_frame(reg))
    await writer.drain()
    return reader, writer


async def _run_client(rank: int, port: int, update: dict,
                      num_samples: float, stats: ClientStats,
                      schedule: FaultSchedule | None,
                      version_probe, server_done, train_delay: float,
                      start_stagger: float, report_corpse=None,
                      reconnect: bool = False,
                      incarnation: int | None = None,
                      sync_delta: bool = False,
                      local_scale: float = 0.0) -> None:
    """One simulated client: persistent connection, real protocol, canned
    uploads, schedule-driven churn. ``version_probe``/``server_done``
    peek at the in-process server so a crashed client knows when its
    rejoin round has arrived without holding a connection.

    ``incarnation`` (constant across this coroutine's reconnects — the
    upload ``seq`` below never resets either) arms the ingest root's
    exactly-once watermarks; ``sync_delta`` opts into lossless delta
    sync bodies and decodes them against the tracked base;
    ``local_scale > 0`` uploads ``synced_params + local_scale * canned``
    instead of the bare canned tree — the small-local-update regime of
    real federated training, where consecutive model versions are
    correlated enough for a delta to beat the dense body (the canned
    random walk is not)."""
    if start_stagger > 0:
        await asyncio.sleep(start_stagger)
    conn = await _connect_and_register(rank, port, server_done,
                                       incarnation, sync_delta)
    if conn is None:
        stats.finished += 1
        return
    reader, writer = conn
    seq = 0
    t_sent = None
    track_model = sync_delta or local_scale > 0
    model = None        # last synced dense-equivalent tree (tracked)
    model_version = -1  # the version that tree corresponds to
    wire = None
    if sync_delta:
        from neuroimagedisttraining_tpu_torch.codec import wire

    async def _lost_connection() -> bool:
        """Unexpected connection loss. Returns True when the client
        should keep running (reconnected — the sharded ingest plane's
        kill-one-worker story: the kernel re-balances the fresh
        connection onto a surviving listener), False to stop."""
        nonlocal reader, writer
        if server_done():
            stats.finished += 1
            return False
        if not reconnect:
            stats.errors += 1
            return False
        stats.errors += 1
        c = await _connect_and_register(rank, port, server_done,
                                        incarnation, sync_delta)
        if c is None:
            stats.finished += 1
            return False
        stats.rejoins += 1
        reader, writer = c
        return True

    while True:
        try:
            msg = await _read_msg(reader)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            if await _lost_connection():
                continue
            return
        if msg.msg_type == M.MSG_TYPE_S2C_FINISH:
            stats.finished += 1
            writer.close()
            return
        version = int(msg.get(M.ARG_ROUND_IDX, 0))
        stats.syncs_seen += 1
        if t_sent is not None:
            if seq % 4 == 0:
                rtt = 1e3 * (time.monotonic() - t_sent)
                stats.rtt_ms.append(rtt)
                # live registry mirror of the RTT percentiles: LIVE
                # for the in-process fleet; spawned fleet
                # shards observe into private registries no shipper
                # sends home, so run_load backfills their samples at
                # fleet-merge time instead (end-of-run visibility).
                obs_fanin.rtt_histogram().observe(rtt)
            t_sent = None
        body = msg.get(M.ARG_MODEL_PARAMS) if track_model else None
        if body is not None:
            if msg.msg_type == M.MSG_TYPE_S2C_SYNC_MODEL:
                stats.sync_bodies += 1
                stats.sync_body_bytes += msg.recv_len
            if wire is not None and wire.is_sync_delta_frame(body):
                if model is None or int(body["base"]) != model_version:
                    # protocol error, handled LOUDLY: never apply a
                    # delta to a base the encoder did not name —
                    # re-register for a dense resync instead
                    stats.delta_errors += 1
                    log.error(
                        "client %d: sync delta names base %s but the "
                        "client holds %d — re-registering for a dense "
                        "resync", rank, body.get("base"), model_version)
                    writer.close()
                    if await _lost_connection():
                        continue
                    return
                model = wire.decode_sync_delta(body, model)
                stats.delta_syncs += 1
            else:
                model = body
            model_version = version
        if schedule is not None and schedule.crashed(version, rank):
            # simulated SIGKILL: drop the connection, then wait out the
            # crash window (rejoin directive) by watching the server's
            # version advance — or leave for good
            stats.crashes += 1
            writer.close()
            if report_corpse is not None:
                # report_corpse takes the server's _rlock — run it on a
                # worker thread so a dispatch-held lock (an aggregation
                # on the card, a drain) never freezes the event loop
                await asyncio.get_running_loop().run_in_executor(
                    None, report_corpse, rank)
            while not server_done():
                v = version_probe()
                if not schedule.crashed(v, rank):
                    conn = await _connect_and_register(
                        rank, port, server_done, incarnation, sync_delta)
                    if conn is None:
                        break  # finished while reconnecting
                    stats.rejoins += 1
                    reader, writer = conn
                    break
                await asyncio.sleep(0.02)
            else:
                stats.finished += 1
                return
            if conn is None:
                stats.finished += 1
                return
            continue
        delay = train_delay
        if schedule is not None:
            delay += schedule.straggle_seconds(version, rank)
        if delay > 0:
            await asyncio.sleep(delay)
        out = M.Message(M.MSG_TYPE_C2S_SEND_MODEL, rank, 0)
        out.add(M.ARG_MODEL_PARAMS,
                _local_update_tree(model, update, local_scale)
                if local_scale > 0 and model is not None else update)
        out.add(M.ARG_NUM_SAMPLES, num_samples)
        out.add(M.ARG_ROUND_IDX, version)
        out.add(M.ARG_UPLOAD_SEQ, seq)
        # wire trace context: the flow STARTS here; the
        # worker's admission and the root's aggregate link to the same
        # id, so the merged trace reads one upload end to end
        ctx = obs_trace.make_trace_ctx(rank, seq)
        out.add(M.ARG_TRACE_CTX, ctx)
        seq += 1
        buf = _frame(out)
        try:
            if obs_trace.TRACER.armed:
                with obs_trace.span("client_upload", client=rank):
                    obs_trace.flow("upload", obs_trace.flow_id_of(ctx),
                                   "s", client=rank)
                    writer.write(buf)
                    await writer.drain()
            else:
                writer.write(buf)
                await writer.drain()
        except (ConnectionError, OSError):
            if await _lost_connection():
                continue
            return
        stats.sent += 1
        stats.bytes_sent += len(buf)
        t_sent = time.monotonic()


def _local_update_tree(base: dict, canned: dict, scale: float):
    """``base + scale * canned``, leaf-wise, dtype-preserving — one
    simulated local training step from the last synced model. Keeps the
    upload structurally identical to the canned tree the servers'
    templates expect."""
    if isinstance(base, dict):
        return {k: _local_update_tree(base[k], canned[k], scale)
                for k in base}
    b = np.asarray(base)
    return b + b.dtype.type(scale) * np.asarray(canned)


def bench_payload(r: int, leaf_elems: int, quant, seed: int):
    """The canned upload of one simulated client — shared by the
    in-process fleet and the spawned fleet shards so the two generators
    stay byte-identical. Secure path: ONE field-element frame (masks
    cancel inside the frame, so reusing it upload-to-upload is sound;
    seq dedups)."""
    if quant is not None:
        from neuroimagedisttraining_tpu_torch.privacy import encode_secure_quant

        rng = np.random.default_rng(31337 * (seed + 1) + r)
        return encode_secure_quant(canned_update_tree(r, leaf_elems),
                                   1.0, quant, rng)
    return canned_update_tree(r, leaf_elems)


def _fleet_proc_main(conn, ranks, port, leaf_elems, secure, seed,
                     train_delay, ready_go, done_ev, reconnect,
                     use_inc=False, sync_delta=False,
                     local_scale=0.0) -> None:
    """Spawned fleet shard (loadgen scale-out). One asyncio client loop
    is ~one core of SYSCALL work, so a single-process fleet caps near the
    server's own throughput and would measure ITSELF. The bench drives
    the server from several fleet processes instead: each shard runs the
    same ``_run_client`` coroutines over its rank slice and ships its
    ``ClientStats`` home over the pipe. The shard imports and builds its
    payloads BEFORE signalling ready, and starts connecting only on the
    go event — interpreter spawn never leaks into the measured window.
    It imports no torch (a torch import would add seconds to its start)
    and never touches the card."""
    quant = None
    if secure:
        from neuroimagedisttraining_tpu_torch.privacy import QuantSpec

        quant = QuantSpec.from_bits(32, 10, 3)

    payloads = {r: bench_payload(r, leaf_elems, quant, seed)
                for r in ranks}
    stats = {r: ClientStats() for r in ranks}

    async def fleet():
        tasks = [asyncio.create_task(_run_client(
            r, port, payloads[r], float(8 + r % 5), stats[r], None,
            lambda: -1, done_ev.is_set, train_delay,
            start_stagger=r * 0.002, report_corpse=None,
            reconnect=reconnect,
            incarnation=(r if use_inc else None),
            sync_delta=sync_delta, local_scale=local_scale))
            for r in ranks]
        await asyncio.gather(*tasks)

    conn.send("ready")  # nidt: allow[lock-send] -- the shard's end of the pipe has exactly one writer: this function, sequentially
    ready_go.wait()
    asyncio.run(fleet())
    conn.send([dataclasses.asdict(s) for s in stats.values()])  # nidt: allow[lock-send] -- same single sequential writer
    conn.close()


# ---------------------------------------------------------------------------
# serve mode: seeded open-loop request fleet against the
# sharded serving plane
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServeClientStats:
    """Per-client serving-fleet counters; every request attempt lands in
    exactly ONE of ok/rejected/errors (the client half of the
    zero-unaccounted-requests audit)."""

    sent: int = 0
    ok: int = 0
    rejected: int = 0
    errors: int = 0
    reconnects: int = 0
    #: client-observed request RTTs (ms), published through the SAME
    #: ``nidt_client_rtt_ms`` path as the ingest fleet at merge
    rtt_ms: list = dataclasses.field(default_factory=list)
    #: site -> {model digest -> count} from /predict replies — the
    #: routing proof (two sites must observe different digests)
    routes: dict = dataclasses.field(default_factory=dict)


def _merge_serve_stats(all_stats) -> ServeClientStats:
    m = ServeClientStats()
    for s in all_stats:
        m.sent += s.sent
        m.ok += s.ok
        m.rejected += s.rejected
        m.errors += s.errors
        m.reconnects += s.reconnects
        m.rtt_ms.extend(s.rtt_ms)
        for site, digests in s.routes.items():
            dst = m.routes.setdefault(site, {})
            for d, n in digests.items():
                dst[d] = dst.get(d, 0) + n
    return m


def _publish_fleet_rtt(rtt_ms) -> None:
    """ONE ``nidt_client_rtt_ms`` publication path for every fleet:
    spawned shards (and the serve clients, which
    never observe live) collected their samples in ``rtt_ms`` lists —
    backfill them into THIS process's histogram so the merged scrape
    carries the distribution without re-measuring."""
    if not rtt_ms:
        return
    h = obs_fanin.rtt_histogram()
    for v in rtt_ms:
        h.observe(float(v))


async def _read_http_response(reader) -> tuple[int, bytes]:
    """Minimal HTTP/1.1 keep-alive response read (status, body)."""
    line = await reader.readline()
    if not line:
        raise ConnectionError("server closed connection")
    status = int(line.split()[1])
    clen = 0
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        if h.lower().startswith(b"content-length:"):
            clen = int(h.split(b":", 1)[1])
    body = await reader.readexactly(clen) if clen else b""
    return status, body


async def _serve_client(rank: int, port: int, shape: tuple,
                        n_requests: int, site: str | None,
                        stats: ServeClientStats, pace_s: float,
                        seed: int, start_stagger: float) -> None:
    """One serving client: a persistent keep-alive connection sending
    ``n_requests`` raw-array /predict POSTs with seeded pacing gaps; on
    a transport error (e.g. its SO_REUSEPORT listener was SIGKILLed) it
    counts the attempt as an error and reconnects — the kernel lands
    the new connection on a surviving listener."""
    await asyncio.sleep(start_stagger)
    rng = np.random.default_rng(100003 * seed + rank)
    body = rng.standard_normal(shape).astype(np.float32).tobytes()
    head = (f"POST /predict HTTP/1.1\r\nHost: nidt\r\n"
            f"Content-Type: application/octet-stream\r\n"
            f"X-NIDT-Shape: {','.join(str(d) for d in shape)}\r\n"
            + (f"X-NIDT-Site: {site}\r\n" if site is not None else "")
            + f"Content-Length: {len(body)}\r\n\r\n").encode() + body
    reader = writer = None
    for i in range(n_requests):
        stats.sent += 1
        t0 = time.perf_counter()
        try:
            if writer is None:
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", port)
                if i:
                    stats.reconnects += 1
            writer.write(head)
            await writer.drain()
            status, payload = await _read_http_response(reader)
            stats.rtt_ms.append((time.perf_counter() - t0) * 1e3)
            if status == 200:
                stats.ok += 1
                reply = json.loads(payload)
                key = site if site is not None else ""
                digests = stats.routes.setdefault(key, {})
                digests[reply["digest"]] = \
                    digests.get(reply["digest"], 0) + 1
            elif 400 <= status < 500:
                stats.rejected += 1
            else:
                stats.errors += 1
        except (OSError, ConnectionError, ValueError,
                asyncio.IncompleteReadError):
            stats.errors += 1
            if writer is not None:
                try:
                    writer.close()
                except OSError:
                    pass
            reader = writer = None
            await asyncio.sleep(0.02)
        if pace_s > 0:
            await asyncio.sleep(float(rng.exponential(pace_s)))
    if writer is not None:
        try:
            writer.close()
            await writer.wait_closed()
        except (OSError, ConnectionError):
            pass


def _serve_fleet_proc_main(conn, ranks, port, shape, n_by_rank, sites,
                           seed, pace_s, ready_go) -> None:
    """Spawned serving fleet shard (same scale-out rationale as
    ``_fleet_proc_main``): run the rank slice's clients, ship their
    ``ServeClientStats`` home over the pipe."""
    stats = {r: ServeClientStats() for r in ranks}

    async def fleet():
        tasks = [asyncio.create_task(_serve_client(
            r, port, tuple(shape), n_by_rank[r],
            sites[r % len(sites)] if sites else None, stats[r], pace_s,
            seed, start_stagger=r * 0.002))
            for r in ranks]
        await asyncio.gather(*tasks)

    conn.send("ready")  # nidt: allow[lock-send] -- the shard's end of the pipe has exactly one writer: this function, sequentially
    ready_go.wait()
    asyncio.run(fleet())
    conn.send([dataclasses.asdict(s) for s in stats.values()])  # nidt: allow[lock-send] -- same single sequential writer
    conn.close()


def _run_serve_load(*, num_clients: int, serve_bundle: str,
                    serve_workers: int, serve_requests: int,
                    serve_kill_at: int, batch_buckets, max_queue_ms,
                    serve_precision: str, seed: int, fleet_procs: int,
                    base_port, metrics_port: int, trace_out: str,
                    flight_out: str, device: str = "cuda") -> dict:
    """``mode="serve"``: drive a seeded open-loop request fleet against
    the sharded serving plane (serve/server.py, its workers serving on
    ``device``) and return the bench cell. ``serve_kill_at >= 0``
    SIGKILLs serve worker 0 once that many requests were served (the
    chaos cell — clients reconnect onto the surviving SO_REUSEPORT
    listeners; the admission audit plus the client-side accounting bound
    every request). The result keeps the reference's ``compile*`` keys:
    a worker's programs are its captured CUDA graphs, one per (model,
    bucket), never captured twice."""
    from neuroimagedisttraining_tpu_torch.serve.bundle import read_manifest
    from neuroimagedisttraining_tpu_torch.serve.server import ShardedServeServer

    if not serve_bundle:
        raise ValueError(
            "mode='serve' requires serve_bundle: a bundle directory "
            "(build one with python -m neuroimagedisttraining_tpu_torch.serve "
            "--from_checkpoint ... --build_only)")
    manifest = read_manifest(serve_bundle)
    shape = tuple(manifest["input_shape"])
    #: route the fleet across the first two personalized site models
    #: (the routing-distinctness proof); a site-less bundle serves the
    #: global model to everyone
    sites = [str(s) for s in manifest["sites"][:2]]
    total = serve_requests if serve_requests > 0 else 2 * num_clients
    n_by_rank = {r: total // num_clients
                 + (1 if r <= total % num_clients else 0)
                 for r in range(1, num_clients + 1)}
    pace_s = 0.01  # seeded exponential think-time between requests

    if trace_out:
        obs_trace.arm(trace_out, tags={"role": "loadgen-serve-root"})
    server = ShardedServeServer(
        serve_bundle, port=int(base_port or 0),
        serve_workers=serve_workers, batch_buckets=tuple(batch_buckets),
        max_queue_ms=max_queue_ms, precision=serve_precision,
        trace_out=trace_out, flight_out=flight_out, device=device)
    msrv = None
    if metrics_port:
        from neuroimagedisttraining_tpu_torch.obs.http import MetricsServer

        msrv = MetricsServer(max(0, int(metrics_port)),
                             registry=server.metrics_view(),
                             health_probe=server.health)

    stats = [ServeClientStats() for _ in range(num_clients + 1)]
    fleet_workers: list[tuple] = []
    ready_go = None
    if fleet_procs > 1:
        ctx = mp.get_context("spawn")
        ready_go = ctx.Event()
        slices = np.array_split(np.arange(1, num_clients + 1),
                                fleet_procs)
        for sl in slices:
            parent_c, child_c = ctx.Pipe(duplex=False)
            p = ctx.Process(
                target=_serve_fleet_proc_main,
                args=(child_c, [int(r) for r in sl], server.port,
                      shape, {int(r): n_by_rank[int(r)] for r in sl},
                      sites, seed, pace_s, ready_go),
                daemon=True, name="nidt-loadgen-serve-fleet")
            p.start()
            child_c.close()
            fleet_workers.append((p, parent_c))
        for p, c in fleet_workers:
            if not c.poll(300.0) or c.recv() != "ready":
                raise RuntimeError(
                    "loadgen serve fleet shard failed to start")

    killed = threading.Event()
    fleet_done = threading.Event()
    if serve_kill_at >= 0:
        def _kill_watch():
            while not fleet_done.is_set():
                if server.total("served") >= serve_kill_at:
                    try:
                        os.kill(server.worker_pids[0], signal.SIGKILL)
                        killed.set()
                    except (OSError, IndexError):
                        pass
                    return
                time.sleep(0.02)

        threading.Thread(target=_kill_watch, daemon=True,
                         name="serve-kill-watch").start()

    t0 = time.monotonic()
    if fleet_procs > 1:
        ready_go.set()
        for p, c in fleet_workers:
            if c.poll(600.0):
                for d in c.recv():
                    stats.append(ServeClientStats(**d))
            p.join(timeout=10.0)
            if p.is_alive():
                p.terminate()
    else:
        async def _fleet():
            tasks = [asyncio.create_task(_serve_client(
                r, server.port, shape, n_by_rank[r],
                sites[r % len(sites)] if sites else None, stats[r],
                pace_s, seed, start_stagger=r * 0.002))
                for r in range(1, num_clients + 1)]
            await asyncio.gather(*tasks)

        asyncio.run(_fleet())
    wall = time.monotonic() - t0
    fleet_done.set()
    fleet = _merge_serve_stats(stats)
    # the one nidt_client_rtt_ms publication path (shared helper with
    # the ingest fleet backfill)
    _publish_fleet_rtt(fleet.rtt_ms)

    audit = server.stop()
    # ---- capture pin: ONE graph per (model, bucket), no recaptures;
    #      a SIGKILLed worker ships no bye, so its pin is unknowable
    #      and skipped (the root's counts still bound its requests) ----
    pin_ok = True
    total_compiles = total_recompiles = dispatches = 0
    requests_dispatched = slots = 0
    batches: dict[str, int] = {}
    compiled_programs: dict[str, list] = {}
    for wid, pw in sorted(audit["per_worker"].items()):
        eng = pw.get("engine")
        if eng is None:
            pin_ok = pin_ok and not pw["alive"]
            continue
        compiled_programs[wid] = eng["compiled"]
        total_compiles += eng["compiles"]
        total_recompiles += eng["recompiles"]
        dispatches += eng["dispatches"]
        requests_dispatched += eng["requests_dispatched"]
        for b, n in eng["batches"].items():
            batches[b] = batches.get(b, 0) + n
            slots += int(b) * n
        pin_ok = (pin_ok and eng["recompiles"] == 0
                  and eng["compiles"] == len(set(eng["compiled"])))
    if audit["dead_workers"] == 0:
        # cross-pin against the fan-in-merged compute-plane counter (a
        # capture counts as a compile there) — worker-labeled cells
        # only: the root registry may carry serve captures of engines
        # run in THIS process (tests), and a
        # killed worker's stale snapshot would skew it (hence the
        # dead_workers guard)
        snap = server.fanin.merged_snapshot().get(
            obs_names.COMPILES_TOTAL)
        metric_compiles = sum(
            c["value"] for c in (snap or {"values": []})["values"]
            if (c["labels"].get("engine") == "serve"
                and "worker" in c["labels"]))
        pin_ok = pin_ok and int(metric_compiles) == total_compiles

    # ---- routing proof: each site observed exactly one digest, and
    #      the digests differ across sites ----
    per_site = {site: sorted(d) for site, d in fleet.routes.items()}
    distinct = (len(per_site) >= 2
                and all(len(d) == 1 for d in per_site.values())
                and len({d[0] for d in per_site.values()})
                == len(per_site))

    received = audit["received"]
    client_exact = (fleet.sent
                    == fleet.ok + fleet.rejected + fleet.errors)
    # every client-confirmed reply had a server verdict; a killed
    # worker's unflushed tail (<= one flush interval) is the only
    # legitimate gap and is reported, not hidden
    unflushed = max(0, fleet.ok + fleet.rejected - received)
    reconciled = bool(
        audit["reconciled"] and client_exact
        and received <= fleet.sent
        and (unflushed == 0 or killed.is_set()))

    merged_text = server.fanin.prometheus_text()
    import re as _re

    result = {
        "mode": "serve",
        "bundle": serve_bundle,
        "model": manifest["model"],
        "model_version": manifest["source_round"],
        "precision": serve_precision or manifest["precision"],
        "num_clients": num_clients,
        "serve_workers": int(serve_workers),
        "batch_buckets": [int(b) for b in batch_buckets],
        "max_queue_ms": float(max_queue_ms),
        "serve_kill_at": (int(serve_kill_at) if serve_kill_at >= 0
                          else None),
        "worker_killed": killed.is_set(),
        "workers_live_at_end": server.live_workers(),
        "wall_s": round(wall, 3),
        "requests_target": total,
        "requests_sent": fleet.sent,
        "requests_ok": fleet.ok,
        "requests_rejected": fleet.rejected,
        "client_errors": fleet.errors,
        "client_reconnects": fleet.reconnects,
        "requests_per_s": round(fleet.ok / wall, 2) if wall else 0.0,
        "rtt_ms_p50": (round(float(np.percentile(fleet.rtt_ms, 50)), 2)
                       if fleet.rtt_ms else None),
        "rtt_ms_p99": (round(float(np.percentile(fleet.rtt_ms, 99)), 2)
                       if fleet.rtt_ms else None),
        "dispatches": dispatches,
        "batches": batches,
        "batch_occupancy": (round(requests_dispatched / slots, 3)
                            if slots else None),
        "compiled_programs": compiled_programs,
        "compiles_total": total_compiles,
        "recompiles_total": total_recompiles,
        "compile_pin_ok": bool(pin_ok),
        "routing": {"per_site": per_site,
                    "distinct_site_models": bool(distinct)},
        "serve_audit": audit,
        "unflushed_with_worker": unflushed,
        "frames_reconciled": reconciled,
        "obs_fanin": server.fanin.summary(),
        "merged_metrics": {
            "port": msrv.port if msrv is not None else None,
            "lines": len(merged_text.splitlines()),
            "worker_labeled": sorted(
                {int(m) for m in _re.findall(r'worker="(\d+)"',
                                             merged_text)}),
            "has_serve_latency":
                (obs_names.SERVE_LATENCY_MS + "_bucket") in merged_text,
            "has_rtt_samples":
                (obs_names.CLIENT_RTT_MS + "_bucket") in merged_text,
        },
    }
    if trace_out:
        obs_trace.disarm()
    if msrv is not None:
        msrv.close()
    return result


class _TimedSyncServer(FedAvgServer):
    """The round-synchronous baseline with advance timestamps, so both
    modes report the same p99 version-advance metric (its mean runs on
    the server's ``device``)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.advance_t: list[float] = []

    def _complete_round(self, n_clients, survivors=None):
        self.advance_t.append(time.monotonic())
        super()._complete_round(n_clients, survivors=survivors)


def run_load(mode: str = "async", num_clients: int = 200,
             aggregations: int = 20, buffer_k: int = 0,
             staleness_alpha: float = 0.5, max_staleness: int = 50,
             fault_spec: str = "", seed: int = 0,
             train_delay: float = 0.0, leaf_elems: int = 256,
             sync_round_deadline: float = 5.0,
             base_port: int | None = None,
             ingest_workers: int = 2,
             ingest_kill_at: int = -1,
             ingest_secure_quant: bool = False,
             regions: int = 0,
             ingest_shm: bool = False,
             sync_delta: bool = False,
             upload_local_scale: float = 0.0,
             fleet_procs: int = 1,
             trace_out: str = "",
             flight_out: str = "",
             metrics_port: int = 0,
             serve_bundle: str = "",
             serve_workers: int = 2,
             serve_requests: int = 0,
             serve_kill_at: int = -1,
             batch_buckets=(1, 2, 4, 8),
             max_queue_ms: float = 2.0,
             serve_precision: str = "",
             device: str = "cuda") -> dict:
    """Drive ``num_clients`` simulated clients against one server and
    return the metrics dict. ``mode="async"`` runs the buffered server
    for ``aggregations`` aggregations of ``buffer_k`` uploads each;
    ``mode="sync"`` runs the round-synchronous server for the number of
    rounds that consumes a comparable upload volume; ``mode="ingest"``
    runs the SHARDED ingest plane (asyncfl/ingest.py):
    ``ingest_workers`` selector worker processes on one SO_REUSEPORT
    port folding partials into the root. ``ingest_kill_at >= 0``
    SIGKILLs worker 0 once the version reaches that value (the chaos
    cell — clients reconnect onto the surviving listeners and the
    audit must stay green, lost uploads accounted). ``fleet_procs > 1``
    shards the CLIENT fleet across that many processes (bench cells
    only — fault schedules need the in-process server probes and pin
    ``fleet_procs=1``); the same fleet drives every mode, so the
    comparison stays generator-fair.

    Tier knobs (``mode="ingest"``): ``regions > 0`` runs the
    HIERARCHICAL tier — that many region sub-aggregator processes, each
    owning ``ingest_workers`` workers on the shared SO_REUSEPORT port
    (``ingest_kill_at`` then SIGKILLs REGION 0, the region chaos cell);
    ``ingest_shm`` hands partials to the parent over double-buffered
    shared-memory slabs instead of the pickled pipe; ``sync_delta``
    lets clients opt into lossless delta sync bodies;
    ``upload_local_scale > 0`` uploads ``synced + scale * canned``
    (the correlated-model regime the downlink-bytes cell measures).

    ``device``: where the servers aggregate (the buffered and the
    synchronous servers' mean, the ingest root's checks) and where the
    serving workers replay their graphs — ``cuda`` unless the caller asks
    for the CPU; without a card it raises, nothing falls back."""
    if mode == "serve":
        if fault_spec:
            raise ValueError(
                "mode='serve' does not take fault_spec; use "
                "serve_kill_at for the serving chaos cell")
        return _run_serve_load(
            num_clients=num_clients, serve_bundle=serve_bundle,
            serve_workers=serve_workers,
            serve_requests=serve_requests,
            serve_kill_at=serve_kill_at, batch_buckets=batch_buckets,
            max_queue_ms=max_queue_ms,
            serve_precision=serve_precision, seed=seed,
            fleet_procs=fleet_procs, base_port=base_port,
            metrics_port=metrics_port, trace_out=trace_out,
            flight_out=flight_out, device=device)
    if mode not in ("async", "sync", "ingest"):
        raise ValueError(
            f"mode must be async|sync|ingest|serve, got {mode!r}")
    from neuroimagedisttraining_tpu_torch.asyncfl.loop import (
        SelectorCommManager,
    )
    from neuroimagedisttraining_tpu_torch.asyncfl.server import (
        BufferedFedAvgServer,
    )
    port = base_port if base_port is not None else free_port_block(2)
    k = int(buffer_k) if buffer_k else num_clients
    init = canned_update_tree(0, leaf_elems)
    schedule = None
    if fault_spec:
        schedule = FaultSchedule(parse_fault_spec(fault_spec), seed)
    # send_timeout mirrors the server's own hardening: a simulated
    # client that stops draining must stall the dispatch thread for at
    # most 2 s, not the 30 s default — the p99 numbers exist to measure
    # the control plane, not one stuck peer
    comm = None
    quant = None
    if mode == "ingest":
        from neuroimagedisttraining_tpu_torch.asyncfl.ingest import (
            ShardedIngestServer,
        )

        if ingest_secure_quant:
            from neuroimagedisttraining_tpu_torch.privacy import QuantSpec

            quant = QuantSpec.from_bits(32, 10, 3)
            if upload_local_scale > 0:
                raise ValueError(
                    "upload_local_scale needs plaintext uploads built "
                    "from the synced model; secure_quant clients ship "
                    "pre-encoded field-element frames")
        if trace_out:
            # the harness process hosts BOTH the in-process client
            # fleet and the ingest root, so arming here captures the
            # client flow starts AND the root merge/aggregate spans;
            # workers arm their own tracers from the wcfg obs config
            obs_trace.arm(trace_out, tags={"role": "loadgen-root"})
        common_kw = dict(
            buffer_k=k, staleness_alpha=staleness_alpha,
            max_staleness=max_staleness, base_port=port,
            secure_quant=quant, trace_out=trace_out,
            flight_out=flight_out, use_shm=ingest_shm,
            sync_delta=sync_delta, device=device)
        if regions > 0:
            from neuroimagedisttraining_tpu_torch.asyncfl.region import (
                HierarchicalIngestServer,
            )

            server = HierarchicalIngestServer(
                init, aggregations, num_clients, regions=regions,
                workers_per_region=ingest_workers, **common_kw)
        else:
            server = ShardedIngestServer(
                init, aggregations, num_clients,
                ingest_workers=ingest_workers, **common_kw)
        rounds = aggregations
    elif mode == "async":
        comm = SelectorCommManager(0, num_clients + 1, base_port=port,
                                   send_timeout=2.0)
        server = BufferedFedAvgServer(
            init, aggregations, num_clients, buffer_k=k,
            staleness_alpha=staleness_alpha, max_staleness=max_staleness,
            comm=comm, device=device)
        rounds = aggregations
    else:
        comm = SelectorCommManager(0, num_clients + 1, base_port=port,
                                   send_timeout=2.0)
        rounds = max(2, (aggregations * k) // num_clients)
        server = _TimedSyncServer(
            init, rounds, num_clients, comm=comm,
            round_deadline=sync_round_deadline,
            quorum=max(1, int(num_clients * 0.6)), device=device)
    server_thread = threading.Thread(target=server.run, daemon=True)

    stats = [ClientStats() for _ in range(num_clients + 1)]

    def version_probe():
        # LOCK-FREE by design: this is polled from the asyncio loop
        # every 20 ms by crashed clients, and taking the server's
        # _rlock here would freeze the whole fleet whenever the
        # dispatch thread holds it (an aggregation, dial-out retries,
        # drain). A torn int read cannot happen in CPython, and the
        # poll only needs eventual progress, not a consistent snapshot.
        return server.round_idx

    server_done = server._done.is_set

    def report_corpse(rank):
        # stand-in for the heartbeat monitor's verdict: the harness
        # KNOWS the schedule just killed this client, so it marks the
        # corpse suspect directly instead of flooding the GIL-bound host
        # with per-client beat frames. Without this, a cohort-sized
        # buffer (buffer_k=0) plus one permanent crash can never fill —
        # _k_eff only shrinks on suspicion. Real deployments arm
        # --heartbeat_interval/--heartbeat_timeout for the same signal.
        # The ingest root keeps the same _suspect/_k_eff machinery; its
        # event loop re-checks the harvest trigger on its next tick.
        if mode in ("async", "ingest"):
            with server._rlock:
                server._suspect.add(rank)
                server._maybe_complete()
        # the sync server's deadline/quorum path handles corpses itself

    def client_payload(r):
        return bench_payload(r, leaf_elems, quant, seed)

    async def _fleet():
        # ~500 connects/s ramp: enough to dodge backlog overflow, short
        # against the measured window
        tasks = [asyncio.create_task(_run_client(
            r, port, client_payload(r), float(8 + r % 5),
            stats[r], schedule, version_probe, server_done, train_delay,
            start_stagger=r * 0.002, report_corpse=report_corpse,
            reconnect=(mode == "ingest"),
            incarnation=(r if mode == "ingest" else None),
            sync_delta=(sync_delta and mode == "ingest"),
            local_scale=upload_local_scale))
            for r in range(1, num_clients + 1)]
        await asyncio.gather(*tasks)

    if fleet_procs > 1 and (schedule is not None or mode == "sync"):
        raise ValueError(
            "fleet_procs > 1 drives bench cells only: fault schedules "
            "need the in-process server probes (version_probe/"
            "report_corpse) and the sync server's barrier needs the "
            "single fleet's completion semantics")
    fleet_workers: list[tuple] = []
    ready_go = done_ev = None
    if fleet_procs > 1:
        # spawn + import + payload build happen BEFORE t0 (children
        # signal ready, then wait for go) — interpreter startup never
        # leaks into the measured accept window
        ctx = mp.get_context("spawn")
        ready_go, done_ev = ctx.Event(), ctx.Event()
        slices = np.array_split(np.arange(1, num_clients + 1),
                                fleet_procs)
        for sl in slices:
            parent_c, child_c = ctx.Pipe(duplex=False)
            p = ctx.Process(
                target=_fleet_proc_main,
                args=(child_c, [int(r) for r in sl], port, leaf_elems,
                      quant is not None, seed, train_delay, ready_go,
                      done_ev, mode == "ingest", mode == "ingest",
                      sync_delta and mode == "ingest",
                      upload_local_scale),
                daemon=True, name="nidt-loadgen-fleet")
            p.start()
            child_c.close()
            fleet_workers.append((p, parent_c))
        for p, c in fleet_workers:
            if not c.poll(300.0) or c.recv() != "ready":
                raise RuntimeError("loadgen fleet shard failed to start")

    msrv = None
    if metrics_port and mode == "ingest":
        # the MERGED view (root + worker-labeled samples + staleness
        # gauges) — what a live scrape of the sharded plane should see
        from neuroimagedisttraining_tpu_torch.obs.http import MetricsServer

        msrv = MetricsServer(max(0, int(metrics_port)),
                             registry=server.metrics_view())

    t0 = time.monotonic()
    server_thread.start()
    if mode == "ingest" and ingest_kill_at >= 0:
        def _kill_watch():
            # the chaos cell: SIGKILL worker 0 (region 0 in the
            # hierarchical tier — worker_pids[0] is the region process)
            # once the version reaches the trigger — its clients
            # reconnect onto the surviving SO_REUSEPORT listeners and
            # the audit must stay green
            while not server_done():
                if server.round_idx >= ingest_kill_at:
                    try:
                        os.kill(server.worker_pids[0], signal.SIGKILL)
                    except (OSError, IndexError):
                        pass
                    return
                time.sleep(0.02)

        threading.Thread(target=_kill_watch, daemon=True).start()
    if fleet_procs > 1:
        ready_go.set()
        if not server._done.wait(timeout=600.0):
            log.warning("loadgen: server not done after 600s; "
                        "collecting what the fleet has")
        done_ev.set()
        for p, c in fleet_workers:
            if c.poll(60.0):
                for d in c.recv():
                    stats.append(ClientStats(**d))
            p.join(timeout=10.0)
            if p.is_alive():
                p.terminate()
    else:
        asyncio.run(_fleet())
    server_thread.join(timeout=60.0)
    wall = time.monotonic() - t0

    fleet = ClientStats()
    for s in stats:
        for f in dataclasses.fields(ClientStats):
            setattr(fleet, f.name,
                    getattr(fleet, f.name) + getattr(s, f.name))
    if fleet_procs > 1:
        # sharded fleets ran EVERY client in spawned processes whose
        # registries never ship home — backfill their RTT samples into
        # this process's histogram so the merged scrape still carries
        # the distribution (in-process fleets observed live above, and
        # run exactly one of the two paths, so no double count); the
        # serve fleet reuses the same publication path
        _publish_fleet_rtt(fleet.rtt_ms)
    if mode in ("async", "ingest"):
        adv_t = [h["t"] for h in server.history]
        accepted = server.upload_stats["accepted"]
        audit = server.upload_audit()
        received = server.upload_stats["received"]
    else:
        adv_t = server.advance_t
        accepted = sum(h["clients"] for h in server.history)
        # the sync server keeps no received/drop counters: a deadline-
        # advanced round legitimately drops late uploads as stale, so
        # `accepted` is a LOWER bound on received, not a proxy for it —
        # only the one-sided bound below is provable in sync mode
        received = None
        audit = {"received_accounted": True, "accepted_accounted": True}
    deltas_ms = (1e3 * np.diff(np.asarray(adv_t))
                 if len(adv_t) >= 2 else np.asarray([]))
    # sustained ingest throughput: uploads that reached an aggregation,
    # over the window from fleet start to the LAST aggregation — the
    # teardown tail (FINISH fan-out, worker joins) measures shutdown,
    # not the ingest plane, and its variance would swamp short cells
    aggregated_hist = sum(h["clients"] for h in server.history)
    accept_window = (adv_t[-1] - t0) if adv_t else None
    sustained = (round(aggregated_hist / accept_window, 2)
                 if accept_window else None)
    buffered_modes = ("async", "ingest")
    result = {
        "mode": mode,
        "num_clients": num_clients,
        "buffer_k": k if mode in buffered_modes else None,
        "staleness_alpha": (staleness_alpha if mode in buffered_modes
                            else None),
        "max_staleness": (max_staleness if mode in buffered_modes
                          else None),
        "rounds_or_aggregations": len(server.history),
        "target": aggregations if mode == "async" else rounds,
        "fault_spec": fault_spec,
        "wall_s": round(wall, 3),
        "uploads_sent": fleet.sent,
        "uploads_accepted": accepted,
        "uploads_per_s": round(accepted / wall, 2) if wall else 0.0,
        "uploads_per_s_sustained": sustained,
        "accept_window_s": (round(accept_window, 3)
                            if accept_window else None),
        "sent_per_s": round(fleet.sent / wall, 2) if wall else 0.0,
        "aggregations_per_s": (round(len(server.history) / wall, 3)
                               if wall else 0.0),
        "version_advance_p50_ms": (round(float(
            np.percentile(deltas_ms, 50)), 2) if deltas_ms.size else None),
        "version_advance_p99_ms": (round(float(
            np.percentile(deltas_ms, 99)), 2) if deltas_ms.size else None),
        # client-observed upload->sync round-trip (sampled every 4th):
        # the per-upload service latency of the whole plane, the number
        # that localizes a throughput ceiling (queueing at the server
        # side shows here long before any process pegs a core)
        "rtt_ms_p50": (round(float(np.percentile(fleet.rtt_ms, 50)), 2)
                       if fleet.rtt_ms else None),
        "rtt_ms_p99": (round(float(np.percentile(fleet.rtt_ms, 99)), 2)
                       if fleet.rtt_ms else None),
        "peak_connections": (server.peak_connection_estimate()
                             if mode == "ingest"
                             else comm.peak_connections),
        "client_stats": {k: v for k, v in
                         dataclasses.asdict(fleet).items()
                         if k != "rtt_ms"},
        "byte_stats": (server.worker_byte_stats() if mode == "ingest"
                       else comm.byte_stats()),
        "upload_audit": audit,
        # async: every client has at most one upload in flight when the
        # server stops reading, so sent can exceed received by at most
        # the fleet size — anything else is a lost or double-counted
        # frame. Ingest: a killed worker's socket buffers can hold any
        # number of sent-but-never-read frames, so only the one-sided
        # received <= sent bound is provable (the audit itself is the
        # zero-lost/zero-double-counted check). Sync: the server keeps
        # no received counter (deadline rounds drop stale uploads by
        # design), so only accepted <= sent is provable.
        "frames_reconciled": bool(
            audit["received_accounted"] and audit["accepted_accounted"]
            and (accepted <= fleet.sent if received is None
                 else (received <= fleet.sent
                       and (mode == "ingest"
                            or fleet.sent - received <= num_clients)))),
        "staleness_hist": (_staleness_hist(server.history)
                           if mode in buffered_modes else None),
    }
    if mode == "ingest":
        result["ingest_workers"] = int(ingest_workers)
        result["ingest_kill_at"] = (int(ingest_kill_at)
                                    if ingest_kill_at >= 0 else None)
        result["workers_live_at_end"] = server.live_workers()
        result["secure_quant"] = bool(ingest_secure_quant)
        result["lost_with_worker"] = int(
            server.upload_stats["lost_with_worker"])
        # ---- hierarchical tier / transport cells ----
        result["ingest_shm"] = bool(ingest_shm)
        result["sync_delta"] = bool(sync_delta)
        result["upload_local_scale"] = (float(upload_local_scale)
                                        if upload_local_scale else None)
        xstats = server.worker_xstats()
        result["worker_xstats"] = xstats
        for kind in ("shm", "pipe"):
            n = xstats.get(f"{kind}_exports", 0)
            result[f"{kind}_export_us_mean"] = (
                round(xstats.get(f"{kind}_export_ns", 0) / n / 1e3, 1)
                if n else None)
        if regions > 0:
            result["regions"] = int(regions)
            result["workers_per_region"] = int(ingest_workers)
            result["lost_with_region"] = int(
                server.upload_stats["lost_with_region"])
        # ---- federation-wide obs summary ----
        result["obs_fanin"] = server.fanin.summary()
        merged_text = server.fanin.prometheus_text()
        import re as _re

        result["merged_metrics"] = {
            "port": msrv.port if msrv is not None else None,
            "lines": len(merged_text.splitlines()),
            "worker_labeled": sorted(
                {int(m) for m in _re.findall(r'worker="(\d+)"',
                                             merged_text)}),
            "region_labeled": sorted(
                {int(m) for m in _re.findall(r'region="(\d+)"',
                                             merged_text)}),
            "has_stage_samples":
                (obs_names.UPLOAD_STAGE_MS + "_bucket") in merged_text,
            "has_rtt_samples": (obs_names.CLIENT_RTT_MS + "_bucket") in merged_text,
        }
        if trace_out:
            flows = obs_fanin.linked_flow_ids(
                server.fanin.merged_trace_events())
            result["merged_trace"] = {
                "path": trace_out,
                "flow_started": len(flows["s"]),
                "flow_stepped": len(flows["t"]),
                "flow_ended": len(flows["f"]),
                "flow_linked": len(flows["linked"]),
            }
            obs_trace.disarm()
    if msrv is not None:
        msrv.close()
    return result


def _staleness_hist(history: list[dict]) -> dict[str, int]:
    hist: dict[str, int] = {}
    for h in history:
        for tau in h.get("taus", ()):
            hist[str(tau)] = hist.get(str(tau), 0) + 1
    return hist


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="neuroimagedisttraining_tpu_torch.asyncfl.loadgen",
        description=__doc__.split("\n\n")[0],
        epilog="Each cell prints as one JSON line, then its summary; "
               "nothing is written unless --out names a file. The "
               "reference's summaries against its committed "
               "bench_matrix/ files (*_vs_committed, "
               "committed_*_uploads_per_s) are left out: those files "
               "hold the JAX package's results, not the port's.")
    ap.add_argument("--clients", type=int, default=1000)
    ap.add_argument("--mode", choices=("async", "sync", "both", "ingest",
                                       "ingest_bench", "region_bench",
                                       "serve"),
                    default="both",
                    help="ingest = one sharded-plane run at "
                         "--ingest_workers; ingest_bench = the headline "
                         "sweep (single-process async baseline, then "
                         "ingest at N in {1, 2, 4} workers); region_bench "
                         "= the hierarchical-tier matrix (tree "
                         "throughput, shm-vs-pipe hand-off, downlink "
                         "delta-sync bytes); serve = "
                         "open-loop request fleet against the serving "
                         "plane (--serve_bundle)")
    ap.add_argument("--aggregations", type=int, default=30,
                    help="async: buffered aggregations to run; the sync "
                         "baseline runs the round count consuming a "
                         "comparable upload volume")
    ap.add_argument("--buffer_k", type=int, default=50,
                    help="aggregate every K accepted uploads (0 = "
                         "cohort size)")
    ap.add_argument("--staleness_alpha", type=float, default=0.5)
    ap.add_argument("--max_staleness", type=int, default=50)
    ap.add_argument("--fault_spec", type=str, default="",
                    help="seeded churn, e.g. 'crash:7@3,rejoin:7@10,"
                         "straggle:0.1:0.05'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train_delay", type=float, default=0.0,
                    help="seconds each client 'trains' per round")
    ap.add_argument("--leaf_elems", type=int, default=256)
    ap.add_argument("--ingest_workers", type=int, default=2,
                    help="selector worker processes for --mode ingest")
    ap.add_argument("--ingest_kill_at", type=int, default=-1,
                    help="SIGKILL ingest worker 0 at this version "
                         "(chaos cell; -1 = never)")
    ap.add_argument("--ingest_secure_quant", action="store_true",
                    help="clients ship secure-quant field-element "
                         "frames; workers fold SlotAccumulator chunks")
    ap.add_argument("--regions", type=int, default=0,
                    help="mode ingest/region_bench: run the "
                         "HIERARCHICAL tier with this many region "
                         "sub-aggregator processes, each owning "
                         "--ingest_workers workers (0 = flat root)")
    ap.add_argument("--ingest_shm", action="store_true",
                    help="hand worker partials to the parent over "
                         "double-buffered shared-memory slabs instead "
                         "of the pickled pipe")
    ap.add_argument("--sync_delta", action="store_true",
                    help="clients opt into lossless delta sync bodies "
                         "(changed-version replies ship the byte delta "
                         "against the client's last-synced version)")
    ap.add_argument("--upload_local_scale", type=float, default=0.0,
                    help="clients upload synced + SCALE * canned "
                         "instead of the bare canned tree (the "
                         "correlated-model regime of the downlink-"
                         "bytes cell); 0 = canned uploads")
    ap.add_argument("--downlink_clients", type=int, default=600,
                    help="mode region_bench: fleet size of the two "
                         "downlink-bytes cells (they measure bytes "
                         "per changed-version sync, not throughput)")
    ap.add_argument("--downlink_aggregations", type=int, default=80,
                    help="mode region_bench: aggregation count of the "
                         "two downlink-bytes cells")
    ap.add_argument("--downlink_leaf_elems", type=int, default=4096,
                    help="mode region_bench: model size of the two "
                         "downlink-bytes cells (large enough that the "
                         "message envelope does not dominate)")
    ap.add_argument("--serve_bundle", type=str, default="",
                    help="mode serve: deployment-bundle directory "
                         "(python -m neuroimagedisttraining_tpu_torch.serve "
                         "--from_checkpoint ... --build_only)")
    ap.add_argument("--serve_workers", type=int, default=2,
                    help="mode serve: HTTP worker processes on the "
                         "shared SO_REUSEPORT port")
    ap.add_argument("--serve_requests", type=int, default=0,
                    help="mode serve: total requests across the fleet "
                         "(0 = 2 per client)")
    ap.add_argument("--serve_kill_at", type=int, default=-1,
                    help="SIGKILL serve worker 0 once this many "
                         "requests were served (chaos cell; -1 = "
                         "never)")
    ap.add_argument("--batch_buckets", type=str, default="1,2,4,8",
                    help="mode serve: declared batch sizes, e.g. "
                         "1,2,4,8")
    ap.add_argument("--max_queue_ms", type=float, default=2.0,
                    help="mode serve: max wait of the oldest queued "
                         "request for batch-mates")
    ap.add_argument("--serve_precision", type=str, default="",
                    choices=("", "bf16", "fp32"),
                    help="mode serve: serving precision override "
                         "('' = as stored in the bundle)")
    ap.add_argument("--metrics_port", type=int, default=0,
                    help="ingest modes: serve the MERGED /metrics "
                         "(root + worker-labeled samples + staleness "
                         "gauges, obs/fanin.py) on this port during "
                         "the run; 0 = off")
    ap.add_argument("--trace_out", type=str, default="",
                    help="ingest modes: write the MERGED Chrome trace "
                         "(client flow starts + worker admission spans "
                         "+ root aggregate spans, clock-aligned) to "
                         "this path; workers write .wN-suffixed local "
                         "secondaries")
    ap.add_argument("--flight_out", type=str, default="",
                    help="ingest modes: write the MERGED flight dump "
                         "(per-worker provenance) to this path")
    ap.add_argument("--fleet_procs", type=int, default=0,
                    help="shard the client fleet across N processes "
                         "(one asyncio loop is ~a core of syscalls — a "
                         "single-process fleet measures itself); 0 = 3 "
                         "for the bench modes, 1 otherwise. Incompatible "
                         "with --fault_spec")
    ap.add_argument("--out", type=str, default="",
                    help="write the JSON cells here (nothing is written "
                         "without it)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the servers aggregate and the serving "
                         "workers replay their graphs (cuda | cpu); "
                         "without a card cuda raises")
    args = ap.parse_args(argv)

    fleet_procs = args.fleet_procs
    if fleet_procs == 0:
        fleet_procs = (3 if args.mode in ("ingest_bench", "region_bench",
                                          "serve")
                       and not args.fault_spec else 1)
    common = dict(
        num_clients=args.clients, aggregations=args.aggregations,
        buffer_k=args.buffer_k, staleness_alpha=args.staleness_alpha,
        max_staleness=args.max_staleness, fault_spec=args.fault_spec,
        seed=args.seed, train_delay=args.train_delay,
        leaf_elems=args.leaf_elems, fleet_procs=fleet_procs,
        device=args.device)
    cells = {}
    if args.mode == "ingest_bench":
        # the headline sweep: the single-process selector baseline,
        # then the sharded plane at N in {1, 2, 4} workers on the SAME
        # cohort/churn/buffer configuration
        cells["async"] = run_load(mode="async", **common)
        print(json.dumps(cells["async"]), flush=True)
        for n in (1, 2, 4):
            cells[f"ingest_w{n}"] = run_load(
                mode="ingest", ingest_workers=n,
                ingest_secure_quant=args.ingest_secure_quant, **common)
            print(json.dumps(cells[f"ingest_w{n}"]), flush=True)
    elif args.mode == "region_bench":
        # the hierarchical-tier matrix. The two TREE cells run the
        # ingest_bench configuration so the headline number is
        # comparable to the single-root cells, and differ ONLY in the partial hand-off transport (the shm-vs-
        # pipe A/B). The two DOWNLINK cells measure bytes per changed-
        # version sync reply in the small-local-update regime
        # (synced + 1e-6 * canned uploads): that is the federated-
        # training dynamics where consecutive versions correlate and a
        # lossless delta can beat the dense body — the stock canned
        # uploads drive the aggregate on a random walk whose version-
        # to-version XOR is incompressible and would measure nothing
        # about the transport.
        tree = dict(regions=(args.regions or 2),
                    ingest_workers=args.ingest_workers)
        cells["tree_shm"] = run_load(mode="ingest", ingest_shm=True,
                                     **tree, **common)
        print(json.dumps(cells["tree_shm"]), flush=True)
        cells["tree_pipe"] = run_load(mode="ingest", **tree, **common)
        print(json.dumps(cells["tree_pipe"]), flush=True)
        dl = dict(common)
        dl.update(num_clients=args.downlink_clients,
                  aggregations=args.downlink_aggregations,
                  leaf_elems=args.downlink_leaf_elems,
                  upload_local_scale=(args.upload_local_scale or 1e-6))
        cells["downlink_delta"] = run_load(mode="ingest",
                                           sync_delta=True, **tree, **dl)
        print(json.dumps(cells["downlink_delta"]), flush=True)
        cells["downlink_dense"] = run_load(mode="ingest", **tree, **dl)
        print(json.dumps(cells["downlink_dense"]), flush=True)
    else:
        modes = (("async", "sync") if args.mode == "both"
                 else (args.mode,))
        for mode in modes:
            kw = dict(common)
            if mode == "ingest":
                kw.update(ingest_workers=args.ingest_workers,
                          ingest_kill_at=args.ingest_kill_at,
                          ingest_secure_quant=args.ingest_secure_quant,
                          regions=args.regions,
                          ingest_shm=args.ingest_shm,
                          sync_delta=args.sync_delta,
                          upload_local_scale=args.upload_local_scale,
                          metrics_port=args.metrics_port,
                          trace_out=args.trace_out,
                          flight_out=args.flight_out)
            elif mode == "serve":
                kw.update(
                    serve_bundle=args.serve_bundle,
                    serve_workers=args.serve_workers,
                    serve_requests=args.serve_requests,
                    serve_kill_at=args.serve_kill_at,
                    batch_buckets=tuple(
                        int(b) for b in args.batch_buckets.split(",")
                        if b.strip()),
                    max_queue_ms=args.max_queue_ms,
                    serve_precision=args.serve_precision,
                    metrics_port=args.metrics_port,
                    trace_out=args.trace_out,
                    flight_out=args.flight_out)
            cells[mode] = run_load(mode=mode, **kw)
            print(json.dumps(cells[mode]), flush=True)
    bench_name = ("ingest_plane" if args.mode == "ingest_bench"
                  else "region_tier" if args.mode == "region_bench"
                  else "serve_plane" if args.mode == "serve"
                  else "async_control_plane")
    out = {"bench": bench_name, **cells}
    if args.mode == "serve":
        c = cells["serve"]
        out["summary"] = {
            "audits_green": bool(c["serve_audit"]["reconciled"]
                                 and c["frames_reconciled"]),
            "requests_per_s": c["requests_per_s"],
            "compile_pin_ok": c["compile_pin_ok"],
            "distinct_site_models":
                c["routing"]["distinct_site_models"],
            "fleet_procs": fleet_procs,
        }
        print(json.dumps({"summary": out["summary"]}), flush=True)
    if args.mode == "ingest_bench":
        base = cells["async"]["uploads_per_s_sustained"]
        out["summary"] = {
            "baseline_uploads_per_s": base,
            **{f"speedup_w{n}": (round(
                cells[f"ingest_w{n}"]["uploads_per_s_sustained"] / base,
                2) if base else None) for n in (1, 2, 4)},
            "audits_green": all(c["upload_audit"]["received_accounted"]
                                and c["upload_audit"]["accepted_accounted"]
                                for c in cells.values()),
            "fleet_procs": fleet_procs,
        }
        print(json.dumps({"summary": out["summary"]}), flush=True)
    if args.mode == "region_bench":
        ts, tp = cells["tree_shm"], cells["tree_pipe"]
        dd, dn = cells["downlink_delta"], cells["downlink_dense"]

        def _per_changed_sync(c):
            cs = c["client_stats"]
            return (round(cs["sync_body_bytes"] / cs["sync_bodies"], 1)
                    if cs["sync_bodies"] else None)

        delta_b = _per_changed_sync(dd)
        dense_b = _per_changed_sync(dn)
        ratio = (round(dense_b / delta_b, 2)
                 if delta_b and dense_b else None)
        tree_sustained = ts["uploads_per_s_sustained"]
        out["summary"] = {
            "regions": ts["regions"],
            "workers_per_region": ts["workers_per_region"],
            "tree_uploads_per_s_sustained": tree_sustained,
            "shm_export_us_mean": ts["shm_export_us_mean"],
            "pipe_export_us_mean": tp["pipe_export_us_mean"],
            "shm_fallback_busy": ts["worker_xstats"].get(
                "shm_fallback_busy", 0),
            "shm_beats_pipe": bool(
                ts["shm_export_us_mean"] and tp["pipe_export_us_mean"]
                and ts["shm_export_us_mean"]
                < tp["pipe_export_us_mean"]),
            "sync_body_bytes_per_changed_sync_delta": delta_b,
            "sync_body_bytes_per_changed_sync_dense": dense_b,
            "delta_sync_bytes_ratio": ratio,
            "delta_sync_3x": bool(ratio and ratio >= 3.0),
            # HONEST fallback accounting: every changed-version reply
            # the delta cell shipped dense anyway, and every delta the
            # clients had to reject, are right here — a 3x claim that
            # hid them behind the mean would be a lie
            "delta_syncs": dd["client_stats"]["delta_syncs"],
            "delta_errors": dd["client_stats"]["delta_errors"],
            "sync_delta_sent": dd["worker_xstats"].get(
                "sync_delta_sent", 0),
            "sync_dense_sent": dd["worker_xstats"].get(
                "sync_dense_sent", 0),
            "sync_dense_fallback_ring": dd["worker_xstats"].get(
                "sync_dense_fallback_ring", 0),
            "lost_with_region": ts["lost_with_region"],
            "audits_green": all(
                c["upload_audit"]["received_accounted"]
                and c["upload_audit"]["accepted_accounted"]
                and c["frames_reconciled"] for c in cells.values()),
            "fleet_procs": fleet_procs,
        }
        print(json.dumps({"summary": out["summary"]}), flush=True)
    if "async" in cells and "sync" in cells:
        a, s = cells["async"], cells["sync"]
        out["summary"] = {
            "uploads_per_s_ratio": (round(a["uploads_per_s"]
                                          / s["uploads_per_s"], 2)
                                    if s["uploads_per_s"] else None),
            "p99_advance_ratio": (round(s["version_advance_p99_ms"]
                                        / a["version_advance_p99_ms"], 2)
                                  if a["version_advance_p99_ms"]
                                  and s["version_advance_p99_ms"]
                                  else None),
        }
        print(json.dumps({"summary": out["summary"]}), flush=True)
    if args.out:
        d = os.path.dirname(args.out)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
    ok = all(c["frames_reconciled"] for c in cells.values())
    return 0 if ok else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
