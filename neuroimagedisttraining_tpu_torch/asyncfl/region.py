"""The hierarchical tier: regional sub-aggregators (the reference
package's ``asyncfl/region.py``).

The sharded ingest plane (``asyncfl/ingest.py``) has one root merging N
workers' partials. This module moves the exact int64 partial fold one
level up::

    silos -> ingest workers -> REGION sub-aggregators -> root

Each region is a process owning its own ``SO_REUSEPORT`` worker fleet (the
same ``_ingest_worker_main`` workers: admission and the int64
``PartialAccumulator`` fold run at the edge, dense and ``--secure_quant``
alike). A region merges its workers' partials and ships ONE merged
partial upstream a root flush, pulling its workers' partials in between
(``flush_interval``) so their accumulators stay small. Integer addition
being exact, commutative and associative, the root's merge of region
partials in region-id order equals the single-root fold bit for bit for
any (region x worker) partitioning.

A region speaks the worker pipe protocol upstream (ready / vb / beats /
obs / clock_reply / reg / partial / bye, and the region-only ``wdead``), so
``HierarchicalIngestServer`` reuses the whole ``ShardedIngestServer``
event loop; it overrides the spawn, a few event kinds and the region
labels of the telemetry.

Worker -> region partials ride the double-buffered shared-memory slabs
under ``use_shm`` (the region is its workers' parent); region -> root
partials stay pickled on the pipe.

A killed REGION takes its workers with it (they see the pipe's EOF and
exit); its silos reconnect to the surviving regions' listeners (one port)
and the root counts the buffered loss as ``lost_with_region``. A worker
dying inside a region is reported upstream as ``wdead`` and counted
``lost_with_worker``. Regions and their workers are spawned and host
code: none calls into ``torch.cuda``.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import queue
import threading
import time

import numpy as np

from neuroimagedisttraining_tpu_torch.asyncfl.ingest import (
    PartialAccumulator, ShardedIngestServer, _ingest_worker_main,
    _ShmSlabReader, model_sizes)
from neuroimagedisttraining_tpu_torch.obs import flight as obs_flight
from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
from neuroimagedisttraining_tpu_torch.obs import names as obs_names
from neuroimagedisttraining_tpu_torch.obs import fanin as obs_fanin

__all__ = ["HierarchicalIngestServer", "REGION_FLUSH_INTERVAL_S"]

log = logging.getLogger("neuroimagedisttraining_tpu_torch.asyncfl")

#: how often a region pulls its workers' partials into the staged
#: accumulator between root flushes — keeps worker-held state (and the
#: loss window of a worker crash) bounded without ever shipping
#: upstream on its own (the ROOT owns buffer_k; an unsolicited region
#: partial would double-trigger harvests)
REGION_FLUSH_INTERVAL_S = 0.25


# ---------------------------------------------------------------------------
# region process
# ---------------------------------------------------------------------------


def _region_main(rid: int, conn, rcfg: dict) -> None:
    """Spawned region entry point (spawn context — fresh interpreter).
    NON-daemonic: a region spawns its own worker fleet, which a
    daemonic process may not; it exits on upstream pipe EOF instead."""
    relay = _RegionRelay(rid, conn, rcfg)
    try:
        relay.run()
    except Exception:  # noqa: BLE001 — log the real error before the
        # process dies; the root sees the sentinel either way
        log.exception("ingest region %d crashed", rid)
        raise


class _RegionRelay:
    """One regional sub-aggregator: worker fleet owner downstream, a
    protocol-faithful 'worker' upstream. One event loop reads every pipe
    and writes upstream; each worker's pipe is written by a sender thread
    of its own (``_send_down``). The loop never blocks on a downstream
    send: a model broadcast (the whole tree) to a worker that is itself
    blocked sending a headroom partial to this loop would otherwise
    deadlock the two, and the root behind them."""

    def __init__(self, rid: int, conn, rcfg: dict):
        self.rid = int(rid)
        self.conn = conn
        self.wpr = int(rcfg["workers_per_region"])
        self.flush_interval = float(
            rcfg.get("flush_interval", REGION_FLUSH_INTERVAL_S))
        self.spawn_timeout = float(rcfg.get("spawn_timeout", 180.0))
        wcfg = rcfg["wcfg"]
        self.spec = wcfg["spec"]
        self.sizes = model_sizes(wcfg["init_params"])
        self._fold_splits = np.cumsum(
            [n for _, n in self.sizes])[:-1]
        #: worker partials merged here between upstream flushes; reset
        #: on every upstream ship
        self.staged = PartialAccumulator(self.spec, self.sizes)
        self.staged_entries: list[tuple] = []
        #: root-triggered collection in flight:
        #: {"rseq": root's flush seq, "seq": internal flush seq,
        #:  "waiting": live wids yet to answer}
        self._pending: dict | None = None
        self._flush_seq = 0
        self._last_headroom = time.monotonic()
        #: c -> wid that last registered it (seqfloor routing)
        self._route: dict[int, int] = {}
        self._announced = False
        self._upq: list[tuple] = []
        self._finishing = False
        self._finish_deadline = 0.0
        self._stop = False
        # ---- worker fleet (global wids: rid*wpr + k) ----
        ctx = mp.get_context("spawn")
        self._workers: dict[int, dict] = {}
        for k in range(self.wpr):
            wid = self.rid * self.wpr + k
            parent, child = ctx.Pipe(duplex=True)
            proc = ctx.Process(
                target=_ingest_worker_main, args=(wid, child, wcfg),
                daemon=True, name=f"nidt-ingest-r{self.rid}-w{wid}")
            proc.start()
            child.close()
            down: queue.SimpleQueue = queue.SimpleQueue()
            threading.Thread(target=self._down_loop, args=(parent, down),
                             daemon=True).start()
            self._workers[wid] = {
                "proc": proc, "conn": parent, "alive": True,
                "ready": False, "acc": 0, "folded": 0, "residual": 0,
                "bye": False, "stats": None, "byte_stats": None,
                "peak_conns": 0, "xstats": None, "shm": None,
                "down": down,
            }

    # ---- downstream (one sender thread a worker) ----

    @staticmethod
    def _down_loop(conn, down: queue.SimpleQueue) -> None:
        """A worker's sender: its commands in order, until the None put at
        teardown; a failed send ends it (the worker's death surfaces on
        its sentinel in the event loop)."""
        while True:
            cmd = down.get()
            if cmd is None:
                return
            try:
                conn.send(cmd)  # nidt: allow[lock-send] -- this thread is the one writer of its worker's pipe: every command reaches it through the worker's queue
            except (BrokenPipeError, OSError):
                return

    def _send_down(self, wid: int, cmd: tuple) -> bool:
        w = self._workers[wid]
        if not w["alive"]:
            return False
        w["down"].put(cmd)
        return True

    # ---- upstream (buffered until the region's own ready) ----

    def _send_up(self, ev: tuple) -> None:
        if not self._announced:
            self._upq.append(ev)
            return
        try:
            self.conn.send(ev)  # nidt: allow[lock-send] -- the region relay's loop thread is the one writer of the upstream pipe, sequentially
        except (BrokenPipeError, OSError):
            self._on_root_gone("upstream send failed")

    def _announce_ready(self) -> None:
        self.conn.send(("ready", self.rid))  # nidt: allow[lock-send] -- the region relay's loop thread is the one writer of the upstream pipe, sequentially
        self._announced = True
        for ev in self._upq:
            self.conn.send(ev)  # nidt: allow[lock-send] -- the region relay's loop thread is the one writer of the upstream pipe, sequentially
        self._upq = []
        log.info("ingest region %d: %d workers ready", self.rid,
                 self.wpr)

    # ---- event loop ----

    def run(self) -> None:
        deadline = time.monotonic() + self.spawn_timeout
        while not all(w["ready"] for w in self._workers.values()):
            if time.monotonic() > deadline:
                self._kill_workers()
                raise RuntimeError(
                    f"region {self.rid}: workers not ready within "
                    f"{self.spawn_timeout}s")
            self._wait_once(timeout=0.1)
            if self._stop:
                return
        self._announce_ready()
        while not self._stop:
            self._wait_once(timeout=0.05)
            self._tick()

    def _wait_once(self, timeout: float) -> None:
        conns = {w["conn"]: wid for wid, w in self._workers.items()
                 if w["alive"]}
        sentinels = {w["proc"].sentinel: wid
                     for wid, w in self._workers.items() if w["alive"]}
        try:
            ready = mp.connection.wait(
                [self.conn] + list(conns) + list(sentinels),
                timeout=timeout)
        except OSError:
            ready = []
        # worker pipes BEFORE sentinels (the root's rule): a dead
        # worker's buffered events are uploads that are NOT lost
        for obj in ready:
            if obj in conns:
                self._drain_worker(conns[obj])
        for obj in ready:
            if obj in sentinels:
                self._mark_worker_dead(sentinels[obj],
                                       "process exited")
        for obj in ready:
            if obj is self.conn:
                self._drain_root()

    def _tick(self) -> None:
        now = time.monotonic()
        if (not self._finishing and self._pending is None
                and now - self._last_headroom >= self.flush_interval):
            # headroom pull: flush workers into the staged accumulator
            # WITHOUT shipping upstream (the root owns buffer_k)
            self._last_headroom = now
            self._flush_seq += 1
            self._broadcast(("flush", self._flush_seq))
        if self._finishing:
            done = all(w["bye"] or not w["alive"]
                       for w in self._workers.values())
            if done or now > self._finish_deadline:
                self._send_merged_bye()

    def _broadcast(self, cmd: tuple) -> list[int]:
        return [wid for wid in self._workers if self._send_down(wid, cmd)]

    # ---- root -> region ----

    def _drain_root(self) -> None:
        while True:
            try:
                if not self.conn.poll():
                    return
                cmd = self.conn.recv()
            except (EOFError, OSError):
                self._on_root_gone("root pipe closed")
                return
            kind = cmd[0]
            if kind == "model":
                self._broadcast(("model", cmd[1], cmd[2]))
            elif kind == "flush":
                self._flush_seq += 1
                waiting = set(self._broadcast(
                    ("flush", self._flush_seq)))
                self._pending = {"rseq": cmd[1],
                                 "seq": self._flush_seq,
                                 "waiting": waiting,
                                 "parts": []}
                if not waiting:
                    self._ship_pending()
            elif kind == "clock":
                # answer for the region itself, then fan the probe down
                # — worker replies are re-tagged upstream with the wid
                # so the root rebases every tier onto its own clock
                self._send_up(("clock_reply", self.rid, cmd[1],
                               time.perf_counter_ns()))
                self._broadcast(("clock", cmd[1]))
            elif kind == "seqfloor":
                c = int(cmd[1])
                wid = self._route.get(c)
                if wid is None or not self._send_down(wid, cmd):
                    # route unknown (e.g. the registering worker died):
                    # broadcast — note_seqfloor is incarnation-guarded
                    # and a pending register pops on one worker only
                    self._broadcast(cmd)
            elif kind == "finish":
                self._finishing = True
                self._finish_deadline = time.monotonic() + 12.0
                self._broadcast(("finish",))
            else:  # pragma: no cover
                log.warning("ingest region %d: unknown root command %r",
                            self.rid, kind)

    def _on_root_gone(self, why: str) -> None:
        if self._stop:
            return
        log.warning("ingest region %d: %s; shutting down", self.rid,
                    why)
        self._kill_workers()
        self._stop = True

    # ---- workers -> region ----

    def _drain_worker(self, wid: int) -> None:
        w = self._workers[wid]
        while True:
            try:
                if not w["conn"].poll():
                    return
                ev = w["conn"].recv()
            except (EOFError, OSError):
                self._mark_worker_dead(wid, "pipe closed")
                return
            self._on_worker_event(wid, ev)

    def _on_worker_event(self, wid: int, ev: tuple) -> None:
        w = self._workers[wid]
        kind = ev[0]
        if kind == "vb":
            w["acc"] += ev[2].get("accepted", 0)
            self._send_up(("vb", self.rid) + tuple(ev[2:]))
        elif kind == "reg":
            self._route[int(ev[2])] = wid
            self._send_up(("reg", self.rid) + tuple(ev[2:]))
        elif kind == "beats":
            self._send_up(("beats", self.rid, ev[2]))
        elif kind == "obs":
            self._send_up(("obs", self.rid, ev[2], wid))
        elif kind == "clock_reply":
            self._send_up(("clock_reply", self.rid, ev[2], ev[3], wid))
        elif kind == "shm_names":
            w["shm"] = [_ShmSlabReader(name, ev[3]) for name in ev[2]]
        elif kind == "partial":
            seq, payload, stats = ev[2], ev[3], ev[4]
            w["stats"] = stats
            if isinstance(payload, dict) and "shm" in payload:
                payload = self._resolve_shm_partial(wid, payload)
            if payload is not None:
                w["folded"] += int(payload["count"])
                self.staged.merge_payload(payload)
                self.staged_entries.extend(payload["entries"])
            if (self._pending is not None
                    and seq == self._pending["seq"]):
                self._pending["waiting"].discard(wid)
                if not self._pending["waiting"]:
                    self._ship_pending()
        elif kind == "bye":
            w["stats"], w["residual"] = ev[2], ev[3]
            w["byte_stats"], w["peak_conns"] = ev[4], ev[5]
            if len(ev) > 6:
                w["xstats"] = ev[6]
            w["bye"] = True
        elif kind == "ready":
            w["ready"] = True
        else:  # pragma: no cover
            log.warning("ingest region %d: unknown worker event %r",
                        self.rid, kind)

    def _resolve_shm_partial(self, wid: int, ctrl: dict) -> dict:
        """The region is its workers' parent: copy the flat vector out
        of the slab, ack it free, rebuild the per-leaf slots (mirrors
        the flat root's resolution, one tier down)."""
        w = self._workers[wid]
        idx = int(ctrl["shm"])
        flat, w_int, count = w["shm"][idx].read(ctrl["gen"])
        self._send_down(wid, ("shm_ack", idx))
        segs = np.split(flat, self._fold_splits)
        slots = {name: seg
                 for (name, _), seg in zip(self.sizes, segs)}
        return {"slots": slots, "w_int": int(w_int),
                "count": int(count), "entries": ctrl["entries"]}

    # ---- merge/ship ----

    def _merged_stats(self) -> dict:
        out: dict[str, int] = {}
        for w in self._workers.values():
            if w["stats"]:
                for k, v in w["stats"].items():
                    out[k] = out.get(k, 0) + int(v)
        return out

    def _ship_pending(self) -> None:
        """Answer the root's flush: ONE merged partial for everything
        staged (worker partials merged in wid order on arrival — order
        is irrelevant to the int64 totals and the root re-sorts entry
        metadata anyway)."""
        rseq = self._pending["rseq"]
        self._pending = None
        self._last_headroom = time.monotonic()
        payload = self.staged.export()
        if payload is not None:
            payload["entries"] = self.staged_entries
            self.staged = PartialAccumulator(self.spec, self.sizes)
            self.staged_entries = []
        self._send_up(("partial", self.rid, rseq, payload,
                       self._merged_stats()))

    def _send_merged_bye(self) -> None:
        """One bye upstream: summed worker stats, the region's TOTAL
        residual (staged-but-unshipped + every worker's own residual),
        summed byte/transport accounting."""
        residual = self.staged.count + sum(
            w["residual"] for w in self._workers.values())
        byte_stats: dict[str, int] = {}
        xstats: dict[str, int] = {}
        peak = 0
        for w in self._workers.values():
            for k, v in (w["byte_stats"] or {}).items():
                byte_stats[k] = byte_stats.get(k, 0) + int(v)
            for k, v in (w["xstats"] or {}).items():
                xstats[k] = xstats.get(k, 0) + int(v)
            peak += int(w["peak_conns"])
        self._send_up(("bye", self.rid, self._merged_stats(), residual,
                       byte_stats, peak, xstats))
        self._kill_workers(join_first=True)
        self._stop = True

    # ---- worker lifecycle ----

    def _mark_worker_dead(self, wid: int, why: str) -> None:
        w = self._workers[wid]
        if not w["alive"]:
            return
        # drain what it shipped before dying — those uploads are safe
        try:
            while w["conn"].poll():
                self._on_worker_event(wid, w["conn"].recv())
        except (EOFError, OSError):
            pass
        w["alive"] = False
        if w["shm"]:
            readers, w["shm"] = w["shm"], None
            for r in readers:
                r.close()
        lost = max(0, w["acc"] - w["folded"] - w["residual"])
        if lost and not w["bye"]:
            w["folded"] += lost
        log.warning("ingest region %d: worker %d dead (%s); %d "
                    "buffered uploads lost with it", self.rid, wid,
                    why, lost if not w["bye"] else 0)
        self._send_up(("wdead", self.rid, wid,
                       lost if not w["bye"] else 0))
        if self._pending is not None:
            self._pending["waiting"].discard(wid)
            if not self._pending["waiting"]:
                self._ship_pending()

    def _kill_workers(self, join_first: bool = False) -> None:
        for w in self._workers.values():
            w["down"].put(None)
            p = w["proc"]
            if join_first:
                p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
            w["alive"] = False
            if w["shm"]:
                readers, w["shm"] = w["shm"], None
                for r in readers:
                    r.close()


# ---------------------------------------------------------------------------
# hierarchical root
# ---------------------------------------------------------------------------


class HierarchicalIngestServer(ShardedIngestServer):
    """The root of the region tree: ``regions`` sub-aggregator
    processes, each owning ``workers_per_region`` ingest workers on the
    SHARED SO_REUSEPORT port. Every ``ShardedIngestServer`` mechanism —
    harvest/merge in child-id order, verdict accounting, watermarks,
    byes, audits — applies verbatim because regions speak the worker
    pipe protocol; the overrides below are the spawn hook, the three
    region-only event shapes, and the region-labeled telemetry
    (``region="R"`` + ``worker="N"`` fan-in tiers, the
    ``nidt_region_staleness`` / ``nidt_region_partial_age_s`` gauges
    the ``region-staleness-runaway`` rule evaluates)."""

    #: a dead CHILD here is a whole region: its buffered-upload loss is
    #: accounted under this key (the audit reconciles it alongside
    #: ``lost_with_worker`` from intra-region worker deaths)
    _lost_key = "lost_with_region"

    def __init__(self, init_params, comm_round: int, num_clients: int,
                 regions: int = 2, workers_per_region: int = 2,
                 flush_interval: float = REGION_FLUSH_INTERVAL_S,
                 **kw):
        if regions < 1:
            raise ValueError(f"regions must be >= 1, got {regions}")
        if workers_per_region < 1:
            raise ValueError(
                f"workers_per_region must be >= 1, got "
                f"{workers_per_region}")
        # read by hooks the parent ctor calls (_spawn_child,
        # _make_fanin, _register_fanin) — set BEFORE super().__init__
        self.regions = int(regions)
        self.workers_per_region = int(workers_per_region)
        self.flush_interval = float(flush_interval)
        super().__init__(init_params, comm_round, num_clients,
                         ingest_workers=regions, **kw)
        self._obs_region_staleness = obs_metrics.gauge(
            obs_names.REGION_STALENESS,
            "max staleness (tau) in the region's last shipped partial "
            "batch", labelnames=("region",))
        self._obs_region_age = obs_metrics.gauge(
            obs_names.REGION_PARTIAL_AGE,
            "seconds since this region last shipped a partial to the "
            "root (a dead or wedged region's age grows forever)",
            labelnames=("region",))

    # ---- hooks the parent ctor calls ----

    def _make_fanin(self) -> obs_fanin.TelemetryFanIn:
        return obs_fanin.TelemetryFanIn(
            labelnames=("region", "worker"))

    def _register_fanin(self, rid: int) -> None:
        for k in range(self.workers_per_region):
            self.fanin.register_worker(
                (rid, rid * self.workers_per_region + k))

    def _spawn_child(self, ctx, rid: int, wcfg: dict):
        rcfg = {"workers_per_region": self.workers_per_region,
                "flush_interval": self.flush_interval,
                "wcfg": wcfg}
        parent, child = ctx.Pipe(duplex=True)
        # NOT daemonic: a region spawns its own worker fleet, which a
        # daemonic process may not; regions exit on root pipe EOF and
        # _kill_workers() reaps them on every root teardown path
        proc = ctx.Process(target=_region_main,
                           args=(rid, child, rcfg), daemon=False,
                           name=f"nidt-ingest-region{rid}")
        proc.start()
        child.close()
        return proc, parent

    # ---- region-only event shapes ----

    def _handle_event(self, rid: int, ev: tuple) -> None:
        kind = ev[0]
        if kind == "obs" and len(ev) > 3:
            # a worker's telemetry payload, region-routed: keyed by
            # BOTH tiers so the merged exposition reads region="R",
            # worker="N"
            self.fanin.ingest((rid, int(ev[3])), ev[2])
            return
        if kind == "clock_reply":
            if len(ev) > 4:
                self.fanin.note_clock((rid, int(ev[4])), ev[2], ev[3],
                                      time.perf_counter_ns())
            # a 4-tuple is the region's own echo — it carries no
            # telemetry of its own, so there is nothing to rebase
            return
        if kind == "wdead":
            # a worker died INSIDE a surviving region: the region
            # already drained what it could; the remainder is a
            # WORKER loss (the region child stays alive and accounted)
            wid, lost = int(ev[2]), int(ev[3])
            w = self._workers[rid]
            if lost:
                self.upload_stats["lost_with_worker"] += lost
                self._obs_uploads.inc(lost, outcome="lost_with_worker")
                w["folded"] += lost
            self.fanin.mark_dead((rid, wid))
            obs_flight.record("region_worker_dead", region=rid,
                              worker=wid, lost=lost,
                              version=self.round_idx)
            log.warning("ingest root: worker %d of region %d died; %d "
                        "uploads lost", wid, rid, lost)
            return
        if kind == "partial":
            payload = ev[3]
            if isinstance(payload, dict) and payload.get("entries"):
                self._obs_region_staleness.set(
                    max(int(e[5]) for e in payload["entries"]),
                    region=str(rid))
            super()._handle_event(rid, ev)
            return
        super()._handle_event(rid, ev)

    def _maybe_harvest(self) -> None:
        now = time.monotonic()
        for rid, w in self._workers.items():
            if w["last_partial_t"] is not None:
                self._obs_region_age.set(
                    round(now - w["last_partial_t"], 3),
                    region=str(rid))
        super()._maybe_harvest()

    # ---- audit ----

    def upload_audit(self) -> dict:
        audit = super().upload_audit()
        # the per-child table IS the per-region table here; aliased so
        # callers reading the tree topology don't need to know the
        # parent class calls its children "workers"
        audit["regions"] = dict(audit["workers"])
        return audit
