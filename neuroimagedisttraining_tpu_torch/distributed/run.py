"""Runnable cross-silo federation: one OS process a rank, real sockets (the
reference package's ``distributed/run.py``)::

    # the aggregation server (rank 0)
    python -m neuroimagedisttraining_tpu_torch.distributed.run --role server \\
        --num_clients 2 --comm_round 5 --model 3dcnn_tiny \\
        --dataset synthetic --base_port 29500

    # one trainer process a silo (ranks 1..N)
    python -m neuroimagedisttraining_tpu_torch.distributed.run --role client \\
        --rank 1 --num_clients 2 --comm_round 5 --model 3dcnn_tiny \\
        --dataset synthetic --base_port 29500

Every rank runs on ``--device`` (``cuda`` by default; ``cpu`` or the
reference's ``--force_cpu`` for the CPU): a silo trains the port's
``LocalTrainer`` on its site shard, held resident on its device, with its
steps as CUDA graph replays on a card; the server aggregates on its own.
Nothing falls back: a silo asked for ``cuda`` without a card raises.

Across machines, give every rank the same ``--hosts 0=10.0.0.1,1=...``
(rank r listens on ``base_port + r``). ``--secure`` runs the additive-share
protocol (``SecureFedAvgServer`` / ``SecureFedAvgClientProc``); with
``--n_aggregators K`` (K processes ``--role aggregator --slot_index j``,
ranks ``num_clients + 1 + j``) slot j goes to aggregator j and no single
node can rebuild a silo's update. ``--secure_quant`` ships field-element
frames instead.

Silo k trains site ``(k - 1) mod num_sites``; the server runs register ->
broadcast -> train -> upload -> aggregate -> finish (``cross_silo.py``) and
prints one JSON line with the rounds completed and the aggregate's norm
(the reference's key set).

Fault tolerance: ``--transport broker`` runs the pub/sub broker (hosted by
the server process); ``--fault_spec "crash:3@1,drop:0.1,..."`` wraps each
silo's transport in the seeded ``FaultyCommManager`` (``faults/chaos.py``);
``--round_deadline`` / ``--quorum`` aggregate survivors instead of waiting
for a dead silo; ``--heartbeat_interval`` / ``--heartbeat_timeout`` drive
suspicion. ``--wire_codec delta+sparse+quant`` encodes every upload
(``codec/wire.py``), its top-k threshold by the ``kth_select`` kernel on a
card; ``--wire_mask_density`` trains the silos masked and ships
bitmap-free frames.

The asynchronous plane: ``--async_server`` runs the buffered FedBuff
server (``asyncfl/server.py``) on the selector core, aggregating every
``--buffer_k`` uploads with no round barrier (``--comm_round`` counts
aggregations); the silos keep one connection open to it
(``asyncfl/loop.PersistentClientCommManager``). ``--ingest_workers N``
shards its ingest over N worker processes on one ``SO_REUSEPORT`` port
(``asyncfl/ingest.py``), ``--regions R`` puts R regional sub-aggregators
of N workers each between them and the root (``asyncfl/region.py``),
``--ingest_shm`` hands the workers' partials over shared memory and
``--sync_delta`` ships a changed model to the silos as the byte delta
against the version each holds. ``--secure_quant`` composes as the
one-phase protocol; dense ``--secure`` does not (a round barrier).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

def dispatch_fallback_note(k: int) -> str | None:
    """Why ``--rounds_per_dispatch`` is 1 on the distributed transport
    (logged once at startup; None when k <= 1): a window needs K rounds
    without the host, and every round of this protocol crosses it."""
    if k <= 1:
        return None
    from neuroimagedisttraining_tpu_torch.engines import (
        program as round_program,
    )

    return (f"rounds_per_dispatch={k} requested; "
            + round_program.report_fallback(
                "distributed", "distributed-control-plane",
                "rounds_per_dispatch=%d on the distributed transport", k))


def cohort_fallback_note(n: int) -> str | None:
    """Why ``--client_mesh`` has nothing to shard here (None when n <= 0):
    each rank trains its own silo; the client axis is the set of
    processes."""
    if n <= 0:
        return None
    from neuroimagedisttraining_tpu_torch.engines import (
        program as round_program,
    )

    return (f"client_mesh={n} requested; "
            + round_program.report_fallback(
                "distributed", "distributed-no-client-axis",
                "client_mesh=%d on the distributed transport", n))


def _parse_hosts(spec: str) -> dict[int, str] | None:
    if not spec:
        return None
    out = {}
    for part in spec.split(","):
        r, ip = part.split("=")
        out[int(r)] = ip
    return out


def _cohort(args) -> dict:
    if args.dataset == "synthetic":
        from neuroimagedisttraining_tpu_torch.data.synthetic import (
            generate_synthetic_abcd,
        )

        return generate_synthetic_abcd(
            num_subjects=args.synthetic_num_subjects,
            shape=tuple(args.synthetic_shape),
            num_sites=max(2, args.num_clients), seed=args.seed,
            signal=args.synthetic_signal)
    from neuroimagedisttraining_tpu_torch.data.hdf5 import load_abcd_hdf5

    return load_abcd_hdf5(args.data_dir, lazy=False)


def _build_shard(args, rank: int):
    """``(X, y, n)``: silo ``rank``'s numpy shard (site ``(rank - 1) mod
    sites`` of the site partition, seed 42)."""
    from neuroimagedisttraining_tpu_torch.data import partition as P

    cohort = _cohort(args)
    train_map, _, _ = P.site_partition(cohort["site"], seed=42)
    site = (rank - 1) % len(train_map)
    idx = train_map[site]
    X = np.asarray(cohort["X"])[idx]
    y = np.asarray(cohort["y"])[idx]
    return X, y, len(idx)


def _optim_from_args(args):
    """The silos' ``OptimConfig``, precision contract included (the wire
    ships float32 master weights either way)."""
    from neuroimagedisttraining_tpu_torch.config import OptimConfig

    return OptimConfig(lr=args.lr, lr_decay=args.lr_decay,
                       batch_size=args.batch_size, epochs=args.epochs,
                       precision=args.precision,
                       loss_scale=args.loss_scale,
                       fused_update=args.fused_update)


def _input_shape(args) -> tuple:
    if args.dataset == "synthetic":
        return tuple(args.synthetic_shape)
    from neuroimagedisttraining_tpu_torch.data.hdf5 import load_abcd_hdf5

    X0 = load_abcd_hdf5(args.data_dir, lazy=True)
    shape = tuple(X0["X"].shape[1:])
    X0["file"].close()
    return shape


def _create_model_from_args(args, shape):
    from neuroimagedisttraining_tpu_torch.core.optim import (
        compute_dtype, resolve_remat,
    )
    from neuroimagedisttraining_tpu_torch.models import create_model

    return create_model(args.model, shape, args.num_classes,
                        dtype=compute_dtype(args.precision),
                        remat=resolve_remat(args.remat, args.precision,
                                            args.batch_size))


def _seed_init_state(args, model=None):
    """``(params, bstats)`` every rank derives alike from ``--seed`` (a CPU
    generator, as the engines' ``init_global_state``), so the init
    broadcast, delta references and wire masks agree across processes with
    no exchange."""
    import torch

    if model is None:
        model = _create_model_from_args(args, _input_shape(args))
    model.to("cpu")
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    return ({k: v.detach().clone() for k, v in model.named_parameters()},
            {k: v.detach().clone() for k, v in model.named_buffers()})


def _build_wire_masks(args, params):
    """The shared pruning mask of ``--wire_mask_density`` every rank
    derives alike (uniform sparsity, drawn from a CPU generator seeded
    ``seed + 97``), as a mask state of the parameters."""
    import torch

    from neuroimagedisttraining_tpu_torch.ops import masks as Mk

    sp = Mk.calculate_sparsities(params, "uniform",
                                 dense_ratio=args.wire_mask_density)
    pm = Mk.init_masks(torch.Generator().manual_seed(args.seed + 97),
                       params, sp)
    return pm


def _wire_mask_tree(pm, bstats) -> dict:
    import torch

    from neuroimagedisttraining_tpu_torch.weights import state_to_flax

    return {"params": state_to_flax(pm, False),
            "batch_stats": state_to_flax(
                {k: torch.ones_like(v) for k, v in bstats.items()}, True)}


def _init_tree(params, bstats) -> dict:
    from neuroimagedisttraining_tpu_torch.weights import state_to_flax

    return {"params": state_to_flax(params, False),
            "batch_stats": state_to_flax(bstats, True)}


def _make_train_fn(args, device):
    """``(train_fn, wire_masks)``: the silo's training closure (the port's
    ``LocalTrainer`` on its resident shard, ``cross_silo.
    make_silo_train_fn``) and the shared wire mask tree under
    ``--wire_mask_density`` (the silo then trains masked: the post-step
    re-mask)."""
    import torch

    from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
    from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (
        make_silo_train_fn,
    )

    X, y, n = _build_shard(args, args.rank)
    model = _create_model_from_args(args, tuple(X.shape[1:]))
    params, bstats = _seed_init_state(args, model)
    wire_masks = mask = None
    if args.wire_mask_density > 0:
        pm = _build_wire_masks(args, params)
        wire_masks = _wire_mask_tree(pm, bstats)
        mask = {k: v.to(device) for k, v in pm.items()}
    trainer = LocalTrainer(model, _optim_from_args(args), device,
                           torch.Generator(device=device),
                           num_classes=args.num_classes)
    shapes = {k: tuple(v.shape) for k, v in
              [*params.items(), *bstats.items()]}
    Xd = torch.from_numpy(np.ascontiguousarray(X)).to(device)
    yd = torch.from_numpy(np.asarray(y, np.int32)).to(device)
    train_fn = make_silo_train_fn(
        trainer, Xd, yd, n, rank=args.rank, seed=args.seed, lr=args.lr,
        lr_decay=args.lr_decay, epochs=args.epochs,
        batch_size=args.batch_size, shapes=shapes, mask=mask)
    return train_fn, wire_masks


def _make_comm(args, rank: int, host_map):
    """The rank's transport by ``--transport``; a silo's is wrapped in
    ``FaultyCommManager`` under ``--fault_spec``. Returns ``(comm,
    broker)``: ``comm`` None means the manager's default socket, ``broker``
    the daemon the server rank hosts."""
    import time

    comm = None
    broker = None
    world_size = args.num_clients + 1 + args.n_aggregators
    if args.transport == "broker":
        from neuroimagedisttraining_tpu_torch.distributed.broker import (
            BrokerCommManager, MessageBroker,
        )

        port = args.broker_port or args.base_port
        if rank == 0:
            broker = MessageBroker(host="0.0.0.0", port=port)
            comm = BrokerCommManager("127.0.0.1", broker.port, client_id=0,
                                     client_num=args.num_clients)
        else:
            host = (host_map or {}).get(0, "127.0.0.1")
            # the server process hosts the broker: back off while it boots
            delay, deadline = 0.25, time.monotonic() + 300
            while True:
                try:
                    comm = BrokerCommManager(host, port, client_id=rank,
                                             client_num=args.num_clients)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(delay)
                    delay = min(2.0, delay * 2)
    elif args.async_server and rank != 0:
        # one connection kept open to the asynchronous server: under
        # --ingest_workers it keeps the silo on one worker, whose ring its
        # sync record (body-less and delta syncs) is kept against
        from neuroimagedisttraining_tpu_torch.asyncfl.loop import (
            PersistentClientCommManager,
        )

        comm = PersistentClientCommManager(rank, world_size,
                                           host_map=host_map,
                                           base_port=args.base_port)
    elif args.fault_spec and rank != 0:
        from neuroimagedisttraining_tpu_torch.distributed.comm import (
            SocketCommManager,
        )

        comm = SocketCommManager(rank, world_size, host_map=host_map,
                                 base_port=args.base_port)
    if args.fault_spec and rank != 0 and comm is not None:
        from neuroimagedisttraining_tpu_torch.faults.chaos import (
            FaultyCommManager,
        )
        from neuroimagedisttraining_tpu_torch.faults.schedule import (
            FaultSchedule, parse_fault_spec,
        )

        comm = FaultyCommManager(
            comm, FaultSchedule(parse_fault_spec(args.fault_spec),
                                args.seed), rank)
    return comm, broker


def add_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The runner's flags: the reference's, and ``--device``."""
    ap.add_argument("--role", required=True,
                    choices=("server", "client", "aggregator"))
    ap.add_argument("--rank", type=int, default=0,
                    help="client rank 1..num_clients (server is 0); "
                         "aggregator j is rank num_clients+1+j")
    ap.add_argument("--slot_index", type=int, default=0,
                    help="aggregator role: which share slot this process "
                         "aggregates (0..n_aggregators-1)")
    ap.add_argument("--n_aggregators", type=int, default=0,
                    help="secure mode: route share slot j to a distinct "
                         "aggregator process instead of the server "
                         "(TurboAggregate grouped aggregation); must equal "
                         "--mpc_n_shares; 0 = single-server degenerate "
                         "mode")
    ap.add_argument("--num_clients", type=int, required=True)
    ap.add_argument("--comm_round", type=int, default=5)  # nidt: allow[flag-config-cross-cli-drift] -- smoke-scale default; the multiprocess runner ships tiny CPU-safe cells
    ap.add_argument("--base_port", type=int, default=29500)
    ap.add_argument("--hosts", type=str, default="",
                    help="rank=ip,... (default: all localhost)")
    ap.add_argument("--transport", type=str, default="socket",
                    choices=("socket", "broker"),
                    help="control-plane transport: point-to-point TCP "
                         "(every rank listens on base_port+rank) or the "
                         "in-repo pub/sub broker (MQTT topic scheme; the "
                         "server process hosts the broker daemon)")
    ap.add_argument("--broker_port", type=int, default=0,
                    help="broker transport: the broker daemon's port "
                         "(0 = base_port); clients connect to rank 0's "
                         "host at this port")
    ap.add_argument("--fault_spec", type=str, default="",
                    help="deterministic chaos schedule applied to client "
                         "ranks via FaultyCommManager: 'crash:RANK@ROUND,"
                         "crash_prob:P,straggle:P:MAX_S,drop:P,dup:P,"
                         "disconnect:P,byz:RANK@ROUND:KIND,"
                         "byz_prob:P[:KIND]' — replays identically from "
                         "--seed on every rank; byz silos upload "
                         "KIND-corrupted values (sign_flip | scale:K | "
                         "gauss:STD | nonfinite, faults/adversary.py) "
                         "transformed BEFORE the wire codec")
    ap.add_argument("--defense", "--defense_type", dest="defense",
                    type=str, default="none",
                    help="server aggregation defense (core/robust.py): "
                         "none | norm_diff_clipping | weak_dp | "
                         "trimmed_mean | median | krum | multi_krum | "
                         "geometric_median — the order-statistic family "
                         "replaces the weighted mean and tolerates up "
                         "to --byz_f Byzantine silos; validated at "
                         "startup on every rank")
    ap.add_argument("--byz_f", type=int, default=1,
                    help="assumed Byzantine silo count f for the order-"
                         "statistic defenses (trim depth per side / "
                         "Krum neighborhood; krum needs num_clients >= "
                         "f+3, trimmed_mean/median need 2f < n) and the "
                         "quarantine budget (at most f silos "
                         "quarantined at once)")
    ap.add_argument("--geomed_iters", type=int, default=8,
                    help="geometric_median: fixed Weiszfeld iterations")
    ap.add_argument("--norm_bound", type=float, default=5.0,
                    help="clip threshold for norm_diff_clipping/weak_dp")
    ap.add_argument("--stddev", type=float, default=0.05,
                    help="weak_dp per-client Gaussian noise stddev "
                         "(draws keyed by --seed, round, silo and leaf)")
    ap.add_argument("--quarantine_rounds", type=int, default=0,
                    help="server: > 0 arms Byzantine DETECTION — "
                         "update-norm/cosine outlier scoring feeds "
                         "strike counters, and --outlier_threshold "
                         "strikes quarantine a silo for this many "
                         "rounds (uploads dropped, codec error-"
                         "feedback reset on release); 0 = off")
    ap.add_argument("--outlier_threshold", type=int, default=2,
                    help="value-anomaly strikes before a silo is "
                         "quarantined (clean rounds forgive one strike "
                         "each)")
    ap.add_argument("--async_server", action="store_true",
                    help="server runs the FedBuff-style buffered "
                         "asynchronous control plane (asyncfl/): the "
                         "selector comm core holds every connection in "
                         "one event loop, uploads are accepted "
                         "continuously and aggregated every --buffer_k "
                         "arrivals with (1+tau)^-alpha staleness "
                         "weighting, broadcasts are version-tagged, and "
                         "there is NO round barrier (comm_round counts "
                         "aggregations). Clients run unchanged")
    ap.add_argument("--buffer_k", type=int, default=0,
                    help="async server: aggregate every K accepted "
                         "uploads (0 = num_clients)")
    ap.add_argument("--staleness_alpha", type=float, default=0.5,
                    help="async server: polynomial staleness exponent; "
                         "an upload tau versions stale weighs "
                         "n * (1+tau)^-alpha")
    ap.add_argument("--ingest_workers", type=int, default=0,
                    help="async server: shard the ingest plane across N "
                         "selector worker PROCESSES on one SO_REUSEPORT "
                         "port (asyncfl/ingest.py) — each worker runs "
                         "the admission gates and folds accepted "
                         "uploads into an exact int64 partial "
                         "aggregate; the root merges partials in "
                         "worker-id order, bitwise-equal to the "
                         "single-process fold. 0 = the single-process "
                         "BufferedFedAvgServer")
    ap.add_argument("--regions", type=int, default=0,
                    help="async server: interpose N regional "
                         "sub-aggregator PROCESSES between the ingest "
                         "workers and the root (asyncfl/region.py) — "
                         "each region owns --ingest_workers workers on "
                         "the shared SO_REUSEPORT port, folds their "
                         "partials locally and ships ONE merged partial "
                         "upstream per flush interval; the root merges "
                         "region partials in region-id order, "
                         "bitwise-equal to the flat fold. 0 = flat root")
    ap.add_argument("--ingest_shm", action="store_true",
                    help="ingest workers hand partials to their parent "
                         "over double-buffered shared-memory slabs "
                         "instead of the pickled pipe (same-host "
                         "fast path; the pipe remains the cross-host "
                         "fallback)")
    ap.add_argument("--sync_delta", action="store_true",
                    help="changed-version sync replies to opted-in "
                         "clients ship the lossless byte delta against "
                         "the client's last-synced version from the "
                         "broadcast ring (dense fallback when the base "
                         "left the ring)")
    ap.add_argument("--max_staleness", type=int, default=20,
                    help="async server: uploads staler than this many "
                         "versions are dropped at admission; the "
                         "built-in staleness rule reads it")
    ap.add_argument("--round_deadline", type=float, default=0.0,
                    help="server: per-round deadline seconds; when it "
                         "fires with >= --quorum uploads the round "
                         "aggregates over the survivors (sample-count "
                         "re-weighted) instead of hanging forever")
    ap.add_argument("--quorum", type=int, default=0,
                    help="min uploads for a deadline aggregation "
                         "(0 = simple majority when --round_deadline is "
                         "set, else all clients)")
    ap.add_argument("--heartbeat_interval", type=float, default=0.0,
                    help="clients: liveness beat period seconds "
                         "(0 = no heartbeats)")
    ap.add_argument("--heartbeat_timeout", type=float, default=0.0,
                    help="server: mark a client suspect once its "
                         "heartbeat is older than this (0 = off)")
    ap.add_argument("--wire_codec", type=str, default="none",
                    help="model-update wire codec (codec/): stages "
                         "joined by '+', e.g. none | delta | sparse | "
                         "quant | delta+sparse+quant (quant16 = bf16). "
                         "Uploads ride as tagged frames the server "
                         "decodes before aggregation; the downlink sync "
                         "stays dense (reference-chain safety)")
    ap.add_argument("--wire_topk_ratio", type=float, default=0.25,
                    help="sparse stage without masks: keep fraction for "
                         "magnitude top-k (error-feedback accumulated "
                         "per silo)")
    ap.add_argument("--wire_mask_density", type=float, default=0.0,
                    help="> 0 emulates a masked engine deployment: every "
                         "rank derives the same seeded pruning mask at "
                         "this density, silos train masked, and the "
                         "codec's sparse stage packs uploads bitmap-free "
                         "(mask handoff). 0 = dense training")
    ap.add_argument("--secure", action="store_true",
                    help="TurboAggregate additive-share aggregation over "
                         "the control plane (dense int64 share slots)")
    ap.add_argument("--secure_quant", action="store_true",
                    help="secure QUANTIZED aggregation "
                         "(privacy/secure_quant.py): uploads ride as "
                         "field-element frames in a small GF(p) — one "
                         "uintN residue per parameter plus seed-expanded "
                         "mask slots. Implies the secure protocol; "
                         "composes with clip-family --defense (enforced "
                         "client-side)")
    ap.add_argument("--secure_quant_field_bits", type=int, default=16,
                    choices=(8, 16, 32),
                    help="secure_quant field width: p = largest prime "
                         "below 2^bits; the wire ships one uintN residue "
                         "per parameter (16 -> uint16)")
    ap.add_argument("--secure_quant_frac_bits", type=int, default=10,
                    help="secure_quant fixed-point fraction bits; the "
                         "aggregate headroom vs p and the cohort is "
                         "validated at startup")
    ap.add_argument("--dp_delta", type=float, default=1e-5,
                    help="target delta for the weak_dp RDP accountant's "
                         "(epsilon, delta) report (privacy/accountant.py)")
    ap.add_argument("--mpc_n_shares", type=int, default=3)
    ap.add_argument("--mpc_frac_bits", type=int, default=16)
    ap.add_argument("--model", type=str, default="3dcnn_tiny")  # nidt: allow[flag-config-cross-cli-drift] -- smoke-scale default; the multiprocess runner ships tiny CPU-safe cells
    ap.add_argument("--num_classes", type=int, default=1)
    ap.add_argument("--dataset", type=str, default="synthetic",
                    choices=("synthetic", "abcd_h5"))  # nidt: allow[flag-config-cross-cli-drift] -- smoke default + the only datasets the socket runner feeds
    ap.add_argument("--data_dir", type=str, default="")  # nidt: allow[flag-config-cross-cli-drift] -- smoke-scale default; the multiprocess runner ships tiny CPU-safe cells
    ap.add_argument("--synthetic_num_subjects", type=int, default=64)  # nidt: allow[flag-config-cross-cli-drift] -- smoke-scale default; the multiprocess runner ships tiny CPU-safe cells
    ap.add_argument("--synthetic_shape", type=int, nargs=3,
                    default=[12, 14, 12])  # nidt: allow[flag-config-cross-cli-drift] -- smoke-scale default; the multiprocess runner ships tiny CPU-safe cells
    ap.add_argument("--synthetic_signal", type=float, default=12.0)
    ap.add_argument("--batch_size", type=int, default=8)  # nidt: allow[flag-config-cross-cli-drift] -- smoke-scale default; the multiprocess runner ships tiny CPU-safe cells
    ap.add_argument("--epochs", type=int, default=1)  # nidt: allow[flag-config-cross-cli-drift] -- smoke-scale default; the multiprocess runner ships tiny CPU-safe cells
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--lr_decay", type=float, default=0.998)
    ap.add_argument("--precision", type=str, default="fp32",
                    choices=("fp32", "bf16_mixed"),
                    help="silo train-step compute dtype; master weights "
                         "(what the wire/codec/secure planes ship) stay "
                         "float32 either way (core/optim.py)")
    ap.add_argument("--loss_scale", type=float, default=1.0,
                    help="fixed loss-scale constant (bf16_mixed only; "
                         "1.0 = off)")
    ap.add_argument("--fused_update", action="store_true",
                    help="the fused SGD step (ops/fused_update.py: the "
                         "fused_sgd kernel on a card, its plain version "
                         "on the CPU)")
    ap.add_argument("--remat", type=str, default="auto",
                    choices=("auto", "none", "stem", "all"),
                    help="3D-model rematerialization policy (auto: stem "
                         "remat past the card's measured batch cutoff)")
    ap.add_argument("--seed", type=int, default=1024)
    ap.add_argument("--device", type=str, default="cuda",
                    help="where this rank trains and aggregates (cuda or "
                         "cpu); cuda needs a card (nothing falls back to "
                         "the CPU)")
    ap.add_argument("--force_cpu", action="store_true",
                    help="run this rank on the CPU (--device cpu)")
    ap.add_argument("--compile_cache", dest="compile_cache", type=str,
                    default=None,
                    help="taken for the reference's command lines and "
                         "ignored: the port's kernels build once into "
                         "the package's build directory")
    ap.add_argument("--rounds_per_dispatch", type=int, default=1,
                    help="accepted for config parity with the main CLI; "
                         "the cross-silo control plane synchronizes with "
                         "every silo each round, so rounds always "
                         "dispatch one at a time here")
    ap.add_argument("--metrics_port", type=int, default=0,
                    help="serve /metrics (Prometheus text) + /healthz "
                         "on this port for the server rank's metrics "
                         "registry (obs/http.py); 0 = off. NOTE: the "
                         "endpoint is unauthenticated and the metrics "
                         "include control-plane state (per-silo DP "
                         "epsilon, upload verdicts) — bind scope via "
                         "--metrics_host")
    ap.add_argument("--metrics_host", type=str, default="0.0.0.0",
                    help="interface the metrics endpoint binds "
                         "(default all interfaces, the Prometheus-"
                         "exporter convention; pass 127.0.0.1 on "
                         "shared hosts)")
    ap.add_argument("--peak_flops", type=float, default=0.0,
                    help="device peak flop/s for the nidt_mfu gauge's "
                         "denominator (obs/compute.py; 0 = the card's "
                         "table value / NIDT_PEAK_FLOPS)")
    ap.add_argument("--trace_out", type=str, default="",
                    help="write this process's host-span timeline as "
                         "Chrome trace-event JSON (obs/trace.py, "
                         "Perfetto-loadable) at exit; give each rank "
                         "its own path")
    ap.add_argument("--flight_events", type=int, default=256,
                    help="flight-recorder ring capacity (obs/flight.py) "
                         "— the last N control-plane decisions kept for "
                         "the post-mortem dump")
    ap.add_argument("--flight_out", type=str, default="",
                    help="flight-recorder dump path: written at end of "
                         "run on the server rank and on any fatal "
                         "failure (failure_context); empty = dumps off")
    ap.add_argument("--health_rules", type=str, default="",
                    help="JSON anomaly-rule manifest extending the "
                         "built-in set (obs/rules.py) on the SERVER "
                         "rank; unknown metric names fail at startup "
                         "against the declared-name list (obs/names.py)")
    ap.add_argument("--health_gate", action="store_true",
                    help="server rank exits nonzero when the run's "
                         "WORST health status was not ok (any anomaly "
                         "rule fired); the machine-readable verdict "
                         "rides the end-of-run JSON either way")
    ap.add_argument("--dp_epsilon_budget", type=float, default=0.0,
                    help="epsilon budget the built-in DP health rules "
                         "judge against (dp-budget-exceeded / "
                         "dp-burn-rate); 0 = no budget rules")
    ap.add_argument("--actions", type=str, default="dry_run",
                    choices=("off", "dry_run", "on"),
                    help="reflex plane (obs/actions.py) on the SERVER "
                         "rank: what a firing health rule's declared "
                         "action DOES. off = rules only observe; dry_run "
                         "(default) = would-fire dispatches are logged/"
                         "flight-recorded with rule provenance but "
                         "nothing changes; on = actions apply "
                         "(quarantine the struck silo through the "
                         "strike machinery, escalate the defense ladder)")
    ap.add_argument("--client_mesh", type=int, default=0,
                    help="accepted for config parity with the main CLI; "
                         "each cross-silo rank trains only its own silo, "
                         "so there is no in-process client axis to shard")
    ap.add_argument("--recipe", type=str, default="",
                    help="autotuner recipe (tune/recipe.py): a recipe "
                         "path, or 'auto' for the committed recipe "
                         "matching this rank's device kind. Applies as "
                         "config DEFAULTS (flags spelled here win, "
                         "override logged); the server rank arms the "
                         "mfu-below-recipe drift rule")
    return ap


def parse(argv=None):
    """The parsed flags after the reference's startup refusals (each an
    argparse error with the reference's message). Returns ``(args,
    quant_spec, fault_spec, recipe_doc)``."""
    ap = add_args(argparse.ArgumentParser(
        prog="neuroimagedisttraining_tpu_torch.distributed.run",
        description=__doc__.split("\n\n")[0]))
    args = ap.parse_args(argv)
    if args.force_cpu:
        args.device = "cpu"
    if args.compile_cache is not None:
        print("[run] --compile_cache: the port has no compile cache; "
              "its kernels build once into the package's build "
              "directory", flush=True)
    recipe_doc = None
    if args.recipe:
        from neuroimagedisttraining_tpu_torch.tune import recipe as tune_recipe

        try:
            recipe_doc = tune_recipe.resolve_and_load(args.recipe,
                                                      device=args.device)
            tune_recipe.apply_recipe(
                args, recipe_doc,
                argv if argv is not None else sys.argv[1:])
        except (OSError, ValueError) as e:
            ap.error(f"--recipe: {e}")
    if args.dp_epsilon_budget < 0:
        ap.error(f"--dp_epsilon_budget must be >= 0 (got "
                 f"{args.dp_epsilon_budget})")
    if args.health_rules:
        # a bad manifest dies here on every rank given the flag
        from neuroimagedisttraining_tpu_torch.obs import names as obs_names
        from neuroimagedisttraining_tpu_torch.obs import rules as obs_rules

        try:
            for r in obs_rules.load_rules(args.health_rules):
                r.validate(obs_names.DECLARED)
        except (OSError, ValueError, TypeError) as e:
            ap.error(f"--health_rules: {e}")
    if args.peak_flops > 0:
        from neuroimagedisttraining_tpu_torch.obs import compute as obs_compute

        obs_compute.PROFILER.set_peak_flops(args.peak_flops)
    quant_spec = None
    if args.secure_quant:
        args.secure = True  # the quantized path IS the secure protocol
        from neuroimagedisttraining_tpu_torch.privacy import (
            QuantSpec, check_headroom,
        )

        try:
            # the field's headroom fails here on every rank, never as
            # wraparound mid-round
            quant_spec = QuantSpec.from_bits(
                args.secure_quant_field_bits,
                args.secure_quant_frac_bits, args.mpc_n_shares)
            check_headroom(quant_spec, args.num_clients)
        except ValueError as e:
            ap.error(str(e))
    if args.rounds_per_dispatch > 1:
        print(f"[dispatch] {dispatch_fallback_note(args.rounds_per_dispatch)}",
              flush=True)
    if args.client_mesh > 0:
        print(f"[cohort] {cohort_fallback_note(args.client_mesh)}",
              flush=True)
    if args.role == "aggregator":
        if args.n_aggregators <= 0:
            ap.error("--role aggregator requires --n_aggregators > 0 "
                     "(same value on every rank)")
        if not 0 <= args.slot_index < args.n_aggregators:
            ap.error(f"--slot_index ({args.slot_index}) must be in "
                     f"[0, {args.n_aggregators})")
    if args.n_aggregators > 0:
        # on EVERY rank: mismatched flags would leave aggregators blocked
        if not args.secure:
            ap.error("--n_aggregators requires --secure")
        if args.n_aggregators != args.mpc_n_shares:
            ap.error(f"--n_aggregators ({args.n_aggregators}) must equal "
                     f"--mpc_n_shares ({args.mpc_n_shares}): slot j "
                     "routes to aggregator j")
    if args.transport == "broker" and args.n_aggregators > 0:
        ap.error("--transport broker routes messages through the MQTT "
                 "topic scheme (server <-> client only); the grouped "
                 "multi-aggregator deployment needs --transport socket")
    if args.secure and (args.wire_codec != "none"
                        or args.wire_mask_density > 0):
        ap.error("--secure uploads must ride the wire as field elements: "
                 "the codec would break the GF(p) share algebra or leak "
                 "mask support. The COMPRESSED secure wire is "
                 "--secure_quant (small-field frames, "
                 "privacy/secure_quant.py) — drop --wire_codec/"
                 "--wire_mask_density and add --secure_quant")
    if args.secure_quant and args.n_aggregators > 0:
        ap.error("--secure_quant does not compose with --n_aggregators: "
                 "mask slots ride as PRG seeds, and any node holding a "
                 "client's seeds can expand every non-data slot — use "
                 "the dense --secure protocol for the grouped "
                 "deployment (see ARCHITECTURE.md 'Privacy plane')")
    if not 0.0 <= args.wire_mask_density < 1.0:
        ap.error(f"--wire_mask_density ({args.wire_mask_density}) must "
                 "be in [0, 1)")
    try:
        # on EVERY rank: a typo'd spec crashing the silos would leave the
        # server blocked in the registration barrier
        from neuroimagedisttraining_tpu_torch.codec.wire import (
            parse_wire_spec,
        )

        parse_wire_spec(args.wire_codec, args.wire_topk_ratio)
    except ValueError as e:
        ap.error(str(e))
    try:
        from neuroimagedisttraining_tpu_torch.core import robust
        from neuroimagedisttraining_tpu_torch.faults.schedule import (
            parse_fault_spec,
        )

        robust.validate_defense(args.defense)
        if args.defense in robust.ROBUST_AGGREGATORS:
            robust._check_f(args.num_clients, args.byz_f, args.defense)
        fault_spec = (parse_fault_spec(args.fault_spec)
                      if args.fault_spec else None)
    except ValueError as e:
        ap.error(str(e))
    if fault_spec is not None and fault_spec.rejoins:
        ap.error("--fault_spec rejoin: is not supported by the "
                 "multiprocess runner (a crashed client process cannot "
                 "revive itself; FaultyCommManager latches the crash). "
                 "Model rejoin by launching a replacement client "
                 "process (the server's late re-register path), or use "
                 "the asyncfl load harness (asyncfl/loadgen.py) whose "
                 "simulated clients honor rejoin deterministically")
    if args.secure:
        if args.quarantine_rounds > 0:
            ap.error("secure aggregation is incompatible with "
                     "--quarantine_rounds: the outlier scorer has no "
                     "per-silo plaintext to score (see ARCHITECTURE.md "
                     "'Privacy plane')")
        if args.defense != "none" and not args.secure_quant:
            ap.error("--secure (dense) is incompatible with --defense: "
                     "additive-share aggregation never reveals per-silo "
                     "updates to defend over. The clip-family defenses "
                     "(norm_diff_clipping, weak_dp) compose with "
                     "--secure_quant, enforced CLIENT-side pre-share — "
                     "add --secure_quant (see ARCHITECTURE.md 'Privacy "
                     "plane')")
        if args.secure_quant and args.defense in robust.ROBUST_AGGREGATORS:
            ap.error(f"--defense {args.defense} is incompatible with "
                     "secure aggregation (quantized included): order "
                     "statistics have no per-silo plaintext to select "
                     "over; only the clip family composes (client-side) "
                     "— see ARCHITECTURE.md 'Privacy plane'")
        if fault_spec is not None and fault_spec.any_value_faults:
            ap.error("--secure cannot simulate byz: value faults (the "
                     "share algebra hides the very values the attack "
                     "would corrupt; see cross_silo)")
    if args.async_server:
        if args.secure and not args.secure_quant:
            ap.error("--async_server is incompatible with dense "
                     "--secure: the two-phase secure weight exchange "
                     "(every client's normalized weight depends on every "
                     "other phase-A reporter) IS a round barrier — "
                     "exactly what the buffered asynchronous protocol "
                     "removes. --secure_quant composes: its one-phase "
                     "frames need no weight exchange (staleness weights "
                     "fold inside the field; see asyncfl/server.py)")
        if args.transport == "broker":
            ap.error("--async_server pairs with the selector socket "
                     "core (asyncfl/loop.py); the broker daemon is a "
                     "thread-per-connection transport with its own "
                     "scaling story — use --transport socket")
        if args.round_deadline > 0 or args.quorum > 0:
            ap.error("--async_server has no round barrier: "
                     "--round_deadline/--quorum do not apply (uploads "
                     "aggregate every --buffer_k arrivals; staleness is "
                     "bounded by --max_staleness instead)")
        if args.buffer_k < 0 or args.max_staleness < 0 \
                or args.staleness_alpha < 0:
            ap.error("--buffer_k/--max_staleness/--staleness_alpha "
                     "must be >= 0")
        if quant_spec is not None:
            from neuroimagedisttraining_tpu_torch.privacy import (
                secure_quant as _sq,
            )

            k_cap = min(args.buffer_k or args.num_clients,
                        args.num_clients)
            if _sq.weighted_fold_capacity(quant_spec) <= k_cap:
                ap.error(
                    "--async_server --secure_quant folds integer-scaled "
                    "staleness weights inside the field, which needs "
                    "headroom the "
                    f"{args.secure_quant_field_bits}-bit field lacks "
                    f"for a {k_cap}-upload buffer — pass "
                    "--secure_quant_field_bits 32")
    if args.ingest_workers:
        if args.ingest_workers < 0:
            ap.error("--ingest_workers must be >= 0")
        if not args.async_server:
            ap.error("--ingest_workers shards the ASYNC ingest plane "
                     "(asyncfl/ingest.py) — add --async_server")
        if args.defense != "none" or args.quarantine_rounds:
            ap.error("--ingest_workers supports neither server-side "
                     "defenses nor quarantine: workers fold uploads "
                     "into partial aggregates, so the root never sees "
                     "per-client updates to select over or score "
                     "(matrix precedent: the buffered secure path). "
                     "Use the single-process plane (--ingest_workers 0) "
                     "or client-side clipping")
    if args.regions:
        if args.regions < 0:
            ap.error("--regions must be >= 0")
        if not args.ingest_workers:
            ap.error("--regions interposes regional sub-aggregators in "
                     "the SHARDED ingest plane — pass --ingest_workers "
                     "N (workers per region) too")
    if (args.ingest_shm or args.sync_delta) and not args.ingest_workers:
        ap.error("--ingest_shm/--sync_delta are sharded-ingest-plane "
                 "transports (asyncfl/ingest.py) — add "
                 "--ingest_workers N")
    if args.round_deadline > 0 and args.quorum == 0:
        args.quorum = args.num_clients // 2 + 1  # simple majority
    if args.heartbeat_timeout > 0 and not (
            0 < args.heartbeat_interval < args.heartbeat_timeout):
        # beats slower than the timeout would mark healthy silos suspect
        ap.error("--heartbeat_timeout requires 0 < --heartbeat_interval "
                 f"< timeout (got interval={args.heartbeat_interval}, "
                 f"timeout={args.heartbeat_timeout})")
    return args, quant_spec, fault_spec, recipe_doc


def main(argv=None) -> int:
    args, quant_spec, fault_spec, recipe_doc = parse(argv)
    import torch

    from neuroimagedisttraining_tpu_torch.device import resolve_device
    from neuroimagedisttraining_tpu_torch.obs import flight as obs_flight
    from neuroimagedisttraining_tpu_torch.obs import trace as obs_trace

    device = resolve_device(args.device)
    # the dump path arms on the server rank only: a crashing silo must
    # never clobber the server's post-mortem file
    obs_flight.configure(capacity=args.flight_events,
                         path=args.flight_out
                         if args.role == "server" else "")
    if args.trace_out:
        obs_trace.arm(args.trace_out,
                      tags={"role": args.role, "rank": args.rank})
    host_map = _parse_hosts(args.hosts)

    from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (
        FedAvgClientProc, FedAvgServer, SecureFedAvgClientProc,
        SecureFedAvgServer, SlotAggregatorProc, named_leaves,
    )

    if args.role == "aggregator":
        agg = SlotAggregatorProc(args.slot_index, args.num_clients,
                                 args.n_aggregators,
                                 base_port=args.base_port,
                                 host_map=host_map)
        print(f"[aggregator {args.slot_index}] rank {agg.rank} "
              f"aggregating slot {args.slot_index}", flush=True)
        agg.run()
        print(json.dumps({"role": "aggregator",
                          "slot_index": args.slot_index,
                          "clients_seen": len(agg.received)}), flush=True)
        return 0

    if args.role == "server":
        return _serve(args, device, host_map, quant_spec, recipe_doc,
                      FedAvgServer, SecureFedAvgServer, named_leaves)

    train_fn, wire_masks = _make_train_fn(args, device)
    cls = SecureFedAvgClientProc if args.secure else FedAvgClientProc
    if args.secure:
        kw = {"n_shares": args.mpc_n_shares,
              "frac_bits": args.mpc_frac_bits, "mpc_seed": args.seed,
              "n_aggregators": args.n_aggregators,
              "quant_spec": quant_spec,
              # the asynchronous plane: one-phase frames (no weight
              # exchange); the clip family runs here, before the share
              "one_phase": bool(args.async_server)}
        if args.secure_quant and args.defense != "none":
            kw.update(defense=args.defense, norm_bound=args.norm_bound,
                      stddev=args.stddev, defense_seed=args.seed)
    else:
        kw = {"wire_codec": args.wire_codec,
              "wire_masks": wire_masks,
              "wire_topk_ratio": args.wire_topk_ratio,
              "sync_delta": args.sync_delta}
    if not args.secure and fault_spec is not None \
            and fault_spec.any_value_faults:
        # value faults live in the silo: it attacks its own upload before
        # any encoding, keyed by the shared (seed, round, rank) schedule
        from neuroimagedisttraining_tpu_torch.faults.schedule import (
            FaultSchedule,
        )
        kw["fault_schedule"] = FaultSchedule(fault_spec, args.seed)
        kw["seed"] = args.seed
    comm, _ = _make_comm(args, args.rank, host_map)
    client = cls(args.rank, args.num_clients, train_fn,
                 base_port=args.base_port, host_map=host_map, comm=comm,
                 heartbeat_interval=args.heartbeat_interval,
                 device=device, **kw)
    print(f"[silo {args.rank}] joining server on {device}", flush=True)
    from neuroimagedisttraining_tpu_torch.ops import _cuda
    from neuroimagedisttraining_tpu_torch.utils.profiling import (
        failure_context,
    )

    _cuda.reset_counts()
    try:
        with failure_context(name=f"silo {args.rank}"):
            client.run()
    finally:
        if args.trace_out:
            obs_trace.dump()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # the silo's own clock and its kernel launches, on the line before
    # its last
    print(json.dumps({"silo": args.rank, "device": str(device),
                      "launches": _cuda.counts(),
                      "train_seconds": client.train_seconds,
                      "encode_seconds": client.encode_seconds,
                      "threshold_calls": client.threshold.calls,
                      "threshold_refined": client.threshold.refined,
                      "threshold_extra_kept": client.threshold.extra_kept,
                      # the transport under a chaos wrapper
                      **getattr(client.com_manager, "inner",
                                client.com_manager).byte_stats()}),
          flush=True)
    print(json.dumps({"role": "client", "rank": args.rank,
                      "rounds_trained": len(client.train_seconds)}),
          flush=True)
    return 0


def _serve(args, device, host_map, quant_spec, recipe_doc, FedAvgServer,
           SecureFedAvgServer, named_leaves) -> int:
    """The server rank: the protocol, the rules and actions, ``/metrics``,
    and the one result line."""
    from neuroimagedisttraining_tpu_torch.obs import actions as obs_actions
    from neuroimagedisttraining_tpu_torch.obs import flight as obs_flight
    from neuroimagedisttraining_tpu_torch.obs import health as obs_health
    from neuroimagedisttraining_tpu_torch.obs import rules as obs_rules
    from neuroimagedisttraining_tpu_torch.obs import trace as obs_trace
    from neuroimagedisttraining_tpu_torch.obs.http import (
        start_metrics_server,
    )
    from neuroimagedisttraining_tpu_torch.utils.profiling import (
        failure_context,
    )

    # the seed's model (and wire mask) every rank derives alike
    params, bstats = _seed_init_state(args)
    init = _init_tree(params, bstats)
    wire_masks = None
    if args.wire_mask_density > 0:
        wire_masks = _wire_mask_tree(_build_wire_masks(args, params),
                                     bstats)
    cls = SecureFedAvgServer if args.secure else FedAvgServer
    if args.secure:
        kw = {"frac_bits": args.mpc_frac_bits,
              "n_aggregators": args.n_aggregators,
              "quant_spec": quant_spec}
        if args.secure_quant and args.defense != "none":
            # the clip family runs on the silos; the server keeps the
            # geometry for the weak_dp ledger
            kw.update(defense=args.defense,
                      norm_bound=args.norm_bound,
                      stddev=args.stddev, defense_seed=args.seed,
                      dp_delta=args.dp_delta)
    else:
        kw = {"wire_masks": wire_masks,
              "defense": args.defense, "byz_f": args.byz_f,
              "geomed_iters": args.geomed_iters,
              "norm_bound": args.norm_bound,
              "stddev": args.stddev, "defense_seed": args.seed,
              "quarantine_rounds": args.quarantine_rounds,
              "outlier_threshold": args.outlier_threshold,
              "dp_delta": args.dp_delta}
    if args.async_server:
        server = _async_server(args, device, host_map, quant_spec, init,
                               kw)
        broker = None
    else:
        comm, broker = _make_comm(args, 0, host_map)
        server = cls(init, args.comm_round, args.num_clients,
                     base_port=args.base_port, host_map=host_map,
                     comm=comm, round_deadline=args.round_deadline,
                     quorum=args.quorum,
                     heartbeat_timeout=args.heartbeat_timeout,
                     device=device, **kw)
        print(f"[server] {args.transport} control plane on port "
              f"{args.broker_port or args.base_port}; waiting for "
              f"{args.num_clients} silos", flush=True)
    extra_rules = ()
    if recipe_doc is not None:
        from neuroimagedisttraining_tpu_torch.tune import recipe as tune_recipe
        extra_rules = tune_recipe.drift_rules(recipe_doc)
    hrules = obs_rules.configure(
        manifest_path=args.health_rules,
        dp_epsilon_budget=args.dp_epsilon_budget,
        comm_round=args.comm_round,
        max_staleness=args.max_staleness,
        extra_rules=extra_rules)
    bus = obs_actions.configure(args.actions)

    # the rules evaluate at round completion, under server._rlock: the
    # handlers run on that thread and never take the lock themselves
    def _act_quarantine(*, rule, round_idx, value=None):
        # the strike machinery's state: the most-struck silo not yet
        # quarantined, the same byz_f budget and ef_reset debt
        cand = {c: n for c, n in server._strikes.items()
                if n > 0 and c not in server._quarantined_now()}
        if not cand:
            return {"status": "skipped",
                    "reason": "no struck silo to attribute the "
                              "alert to"}
        if len(server._quarantined_now()) >= max(1, server.byz_f):
            return {"status": "skipped",
                    "reason": f"quarantine budget (byz_f="
                              f"{server.byz_f}) spent"}
        c = max(cand, key=lambda k: (cand[k], -k))
        until = (server.round_idx + 1
                 + max(1, server.quarantine_rounds))
        server._quarantine_until[c] = until
        server._strikes[c] = 0
        server._ef_reset_pending.add(c)
        server.byz_stats["quarantines"].append(
            {"client": c, "from_round": server.round_idx + 1,
             "until_round": until})
        return {"client": c, "from_round": server.round_idx + 1,
                "until": until, "strikes": cand[c]}

    def _act_escalate(*, rule, round_idx, value=None):
        from neuroimagedisttraining_tpu_torch.core import robust
        ladder = ("none", "norm_diff_clipping", "trimmed_mean")
        if args.secure or args.secure_quant:
            return {"status": "skipped",
                    "reason": "secure planes clip client-side; no "
                              "server defend tail to escalate"}
        cur = server.defense
        if cur not in ladder:
            return {"status": "skipped",
                    "reason": f"operator defense {cur!r} is "
                              "outside the escalation ladder"}
        if cur == ladder[-1]:
            return {"status": "skipped",
                    "reason": f"already at the top rung {cur!r}"}
        nxt = ladder[ladder.index(cur) + 1]
        if nxt in robust.ROBUST_AGGREGATORS:
            try:
                robust._check_f(args.num_clients, server.byz_f, nxt)
            except ValueError as e:
                return {"status": "skipped", "reason": str(e)}
        server.defense = nxt
        return {"from": cur, "to": nxt}

    bus.register("quarantine_silo", _act_quarantine)
    bus.register("escalate_defense", _act_escalate)
    if args.async_server:
        def _act_adapt_buffer(*, rule, round_idx, value=None):
            # a staleness runaway: aggregate more eagerly (halve the
            # trigger) and discount stale arrivals harder
            old_k = server.buffer_k
            old_a = server.staleness_alpha
            new_k = max(1, (old_k + 1) // 2)
            new_a = min(old_a + 0.25, 2.0)
            if new_k == old_k and new_a == old_a:
                return {"status": "skipped",
                        "reason": "buffer_k at its floor and "
                                  "staleness_alpha at its cap"}
            server.buffer_k = new_k
            server.staleness_alpha = new_a
            return {"buffer_k": [old_k, new_k],
                    "staleness_alpha": [old_a, new_a]}

        bus.register("adapt_buffer", _act_adapt_buffer)

    def _health() -> dict:
        # a bounded lock wait: a busy server reports busy, itself a
        # liveness signal
        from neuroimagedisttraining_tpu_torch.obs import (
            compute as obs_compute,
        )

        if not server._rlock.acquire(timeout=0.2):
            return {"busy": True,
                    "compute": obs_compute.PROFILER.health(),
                    "health": obs_rules.health_block(),
                    "actions": bus.actions_block()}
        try:
            h = {"round": int(server.round_idx),
                 "registered": len(server._registered),
                 "suspects": len(server._suspect),
                 "compute": obs_compute.PROFILER.health(),
                 "fallbacks": obs_health.fallback_block(
                     server.fanin.merged_snapshot()
                     if args.ingest_workers else None),
                 "health": obs_rules.health_block(),
                 "actions": bus.actions_block()}
            if args.async_server:
                h["buffered"] = (server._pending() if args.ingest_workers
                                 else len(server._buffer))
        finally:
            server._rlock.release()
        return h

    # the sharded plane serves the merged view: the root's samples, the
    # workers' (labelled), their snapshots' ages
    msrv = start_metrics_server(args.metrics_port, health_probe=_health,
                                registry=(server.metrics_view()
                                          if args.ingest_workers else None),
                                host=args.metrics_host)
    if msrv is not None:
        print(f"[server] obs: /metrics + /healthz on port {msrv.port}"
              + (" (merged across ingest workers)"
                 if args.ingest_workers else ""), flush=True)
    clean_exit = False
    try:
        # failure_context dumps the flight ring before re-raising
        with failure_context(name="cross-silo server"):
            server.run()
        clean_exit = True
    finally:
        # the sharded root writes the merged artifacts at the bare paths
        # itself (ShardedIngestServer.dump_obs)
        if not args.ingest_workers:
            if args.flight_out and clean_exit:
                obs_flight.dump(reason="end of run")
            if args.trace_out:
                obs_trace.dump()
        if msrv is not None:
            msrv.close()
        if not clean_exit:
            obs_rules.disarm()
            obs_actions.disarm()
    if broker is not None:
        broker.stop()
    norm = float(np.sqrt(sum(
        float(np.sum(np.asarray(v, np.float64) ** 2))
        for v in named_leaves(server.params).values())))
    stats = server.com_manager.byte_stats()
    extra = {}
    timing = {}
    if args.async_server:
        extra = {"async_server": True,
                 # the server's values, not the flags: adapt_buffer may
                 # have changed them
                 "buffer_k": server.buffer_k,
                 "staleness_alpha": server.staleness_alpha,
                 "max_staleness": args.max_staleness,
                 "upload_audit": server.upload_audit(),
                 "staleness_taus": sorted({
                     t for h in server.history
                     for t in h.get("taus", ())})}
        timing = {"versions": [{k: h[k] for k in
                                ("version", "contributors", "taus",
                                 "weights", "t")}
                               for h in server.history]}
        if args.ingest_workers:
            extra["ingest_workers"] = args.ingest_workers
            if args.regions:
                extra["regions"] = args.regions
            if args.ingest_shm or args.sync_delta:
                extra["worker_xstats"] = server.worker_xstats()
            # the workers own the silos' sockets and their byte counts
            stats = server.worker_byte_stats()
            timing["upload_stage_ms"] = _stage_summary(
                server.fanin.merged_snapshot())
    dp = server.dp_report()
    if dp is not None:
        extra["dp"] = dp
    if args.async_server:
        server._observe_health_boundary()
    else:
        obs_rules.observe_boundary(int(server.round_idx))
    health_verdict = hrules.verdict()
    obs_rules.disarm()
    obs_actions.disarm()
    extra["health"] = {
        k: health_verdict[k]
        for k in ("status", "worst_status", "alerts_total",
                  "rounds_evaluated")}
    extra["health_timeline"] = health_verdict["timeline"]
    extra["actions"] = bus.actions_block()
    # the server's own clock: each aggregation's seconds, on the line
    # before the result
    print(json.dumps({"server": str(device),
                      "aggregate_seconds": server.aggregate_seconds,
                      **timing}), flush=True)
    print(json.dumps({"rounds_completed": len(server.history),
                      "clients": args.num_clients,
                      "secure": bool(args.secure),
                      "secure_quant": bool(args.secure_quant),
                      "transport": args.transport,
                      "wire_codec": args.wire_codec,
                      "wire_mask_density": args.wire_mask_density,
                      "suspects": sorted(server.suspect_clients()),
                      "defense": getattr(server, "defense", "none"),
                      "quarantined": sorted(
                          server.quarantined_clients()),
                      "byz_stats": server.byz_stats,
                      "final_param_norm": round(norm, 6),
                      **extra, **stats}), flush=True)
    if args.health_gate and health_verdict["worst_status"] != "ok":
        print(f"[health] gate FAILED: worst status "
              f"{health_verdict['worst_status']!r} "
              f"({health_verdict['alerts_total']} alert(s))",
              file=sys.stderr, flush=True)
        return 1
    return 0


def _stage_summary(snapshot: dict) -> dict:
    """The upload-stage histogram (``nidt_upload_stage_ms``) of a merged
    snapshot, summed over the workers: each stage's count and total ms."""
    from neuroimagedisttraining_tpu_torch.obs import names as obs_names

    out: dict = {}
    for cell in snapshot.get(obs_names.UPLOAD_STAGE_MS, {}).get(
            "values", []):
        stage = cell["labels"].get("stage")
        agg = out.setdefault(stage, {"count": 0, "sum_ms": 0.0})
        agg["count"] += int(cell["value"]["count"])
        agg["sum_ms"] += float(cell["value"]["sum"])
    return out


def _async_server(args, device, host_map, quant_spec, init, kw):
    """The asynchronous plane's root: ``BufferedFedAvgServer``, or the
    sharded ingest root (``--ingest_workers``), or the region tree
    (``--regions``)."""
    from neuroimagedisttraining_tpu_torch.asyncfl import (
        BufferedFedAvgServer,
    )

    if args.secure_quant:
        # the buffered server speaks one-phase secure_quant itself
        kw = {"secure_quant": quant_spec, "defense": args.defense,
              "norm_bound": args.norm_bound, "stddev": args.stddev,
              "defense_seed": args.seed, "dp_delta": args.dp_delta}
    if not args.ingest_workers:
        server = BufferedFedAvgServer(
            init, args.comm_round, args.num_clients,
            buffer_k=args.buffer_k, staleness_alpha=args.staleness_alpha,
            max_staleness=args.max_staleness, base_port=args.base_port,
            host_map=host_map, heartbeat_timeout=args.heartbeat_timeout,
            device=device, **kw)
        print(f"[server] asyncfl selector control plane on port "
              f"{args.base_port}; buffer_k={server.buffer_k}, "
              f"staleness_alpha={args.staleness_alpha}, max_staleness="
              f"{args.max_staleness}", flush=True)
        return server
    ikw = dict(buffer_k=args.buffer_k,
               staleness_alpha=args.staleness_alpha,
               max_staleness=args.max_staleness, base_port=args.base_port,
               host_map=host_map, heartbeat_timeout=args.heartbeat_timeout,
               trace_out=args.trace_out, flight_out=args.flight_out,
               use_shm=args.ingest_shm, sync_delta=args.sync_delta,
               device=device, **kw)
    if args.regions:
        from neuroimagedisttraining_tpu_torch.asyncfl.region import (
            HierarchicalIngestServer,
        )

        server = HierarchicalIngestServer(
            init, args.comm_round, args.num_clients, regions=args.regions,
            workers_per_region=args.ingest_workers, **ikw)
        topo = (f"{args.regions} regions x {args.ingest_workers} workers "
                "(hierarchical tier)")
    else:
        from neuroimagedisttraining_tpu_torch.asyncfl.ingest import (
            ShardedIngestServer,
        )

        server = ShardedIngestServer(
            init, args.comm_round, args.num_clients,
            ingest_workers=args.ingest_workers, **ikw)
        topo = f"{args.ingest_workers} selector workers"
    print(f"[server] sharded ingest plane on port {args.base_port}: "
          f"{topo} (SO_REUSEPORT), buffer_k={server.buffer_k}, "
          f"staleness_alpha={args.staleness_alpha}, max_staleness="
          f"{args.max_staleness}"
          + (", shm partial hand-off" if args.ingest_shm else "")
          + (", delta sync" if args.sync_delta else ""), flush=True)
    return server


if __name__ == "__main__":
    sys.exit(main())
