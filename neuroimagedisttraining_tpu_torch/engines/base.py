"""The pieces every engine shares: client sampling, local training of one
client, the sample-weighted FedAvg with its non-finite-upload guard,
personal-state lists and their scatter, global / personal evaluation, the
reference's ``stat_info`` accumulators and the experiment log.

Clients run one after another in a Python loop (PyTorch's form of the
reference's ``vmap`` over a client axis); their states are dicts of
tensors on the device, and a round syncs with the host only where the
host needs a value (the round's loss and evaluation metrics).

An engine reads its clients' rows from the resident federation
(``data/federate.py``) or from a streamed one (``data/stream.py``), the
reference package's ``engines/base.py:104-147``. Every read goes through
:meth:`FederatedEngine.client_rows`, a walk over a list of clients: on the
resident path it slices the stacks; on the streamed path it serves each
client from the current chunk of ``_eval_chunk_size()`` clients while the
next chunk is on its way. A client's result does not depend on the chunk
it came in, so a streamed run equals the resident one. :meth:`plan_walks`
tells the feed the walks a round makes (training, then the evaluations,
then the next round's training), so the last chunk of each walk
prefetches the first of the next.

The engine owns its :class:`~engines.program.RoundProgram` (``program``):
the reference's fallback keys and window planner. Under
``--rounds_per_dispatch K`` an engine that declares its round
(``round_stages``) runs windows of up to K rounds (``run_rounds``), whose
host reads wait for the window's end (one read a window,
:meth:`FederatedEngine.read_host`) and whose local steps run as CUDA graphs
on a card. Under ``--client_mesh N`` (a :class:`~parallel.mesh.Mesh` of N
entries) the sampled clients of a round are split over the mesh's entries
(:meth:`FederatedEngine.map_clients`, ``parallel/cohort.py``); on a
two-level ``--mesh_shape S C`` mesh the mean is taken silo first
(``parallel/hierarchical.py``); D-PSGD and DisPFL gossip over the mesh
(``parallel/gossip.py``). On a mesh that spans ranks each rank trains its
own entries' clients, in rank order from the generator state the rank
before it left, and the ranks exchange the trained states, so every rank
runs the same round tail. A streamed round pads nothing (sharding
refuses streaming, as the reference's ``streaming-sharded-feed``; the feed
places each fetch over the mesh's entries).

The round's tail (``defended_aggregate``) runs, in the reference's order:
the Byzantine attack on the uploads of the clients the fault schedule
names (``faults/adversary.py``), the wire codec's lossy roundtrip
(``codec/device.py``, with per-client error feedback where the engine
declares it), the non-finite guard, the defense and the aggregation
(``core/robust.py``). With no attack, codec or defense it is the plain
guarded FedAvg, bit for bit. Under ``--secure_quant`` the guard, defense
and mean give way to the GF(p) fold of secure quantized aggregation
(``secure_quant_aggregate``; ``ops/mpc_device.py`` ``secure_quant_fold``):
the clip family clips each client first, and a non-finite row is counted
but folds as the zero residue at its weight, as in the host protocol. The
engines that run it say so by their ``supports_*`` flags, and the
constructor refuses what an engine does not run, with the reference's
messages. ``record_privacy`` charges the RDP accountant (``privacy/``) for
every round of an armed noise path.

Checkpoints (``--checkpoint_dir``, ``--checkpoint_every``;
``utils/checkpoint.py``): after every ``checkpoint_every``-th round and
the last, the engine saves the state dict the reference's saves, under
its keys (the models as the reference's flax trees, per-client states
stacked), with ``stat_info``'s numbers and lists, and the trainer's
generator, whose state the later rounds' draws continue from; a run
resumes from the newest at the next round, bit for bit the uninterrupted
run (:meth:`FederatedEngine.restore_checkpoint`). The wire codec's
error feedback is not saved, as in the reference: a resumed codec run
restarts it at zero.

The telemetry plane (``obs/``) reads the run at its host boundaries: a
span a window or round, a flush and an evaluation
(``obs/trace.py``); the dispatch time and the rounds of every window
(``obs/compute.py``, MFU over the wall time between boundaries); the
round's health stats under ``--health_stats`` (computed in the round's
tail, ``engines/program.py``, read in the window's one host read and
published by ``obs/health.py``); ``stat_info`` and the DP ledger as
gauges; the rules (``obs/rules.py``) at each boundary, whose reflex
actions (``obs/actions.py``) the engine realizes: ``quarantine_silo``
(the client of the lowest leave-one-out cosine leaves the cohort for 5
rounds), ``escalate_defense`` (none -> norm_diff_clipping ->
trimmed_mean) and ``freeze_rollback`` (the next boundary restores the
last healthy pinned model). A ``preempt:NDEV@ROUND`` fault shrinks the
mesh of a FedAvg-family run to its first NDEV entries and resumes from
the last checkpoint (or goes on from the live state), recorded as
``shrink_mesh``; the other engines ignore it, as the reference's do. A rollback,
an escalation and a shrink drop the trainer's step graphs, which the
next round captures again. Every engine's ``train()`` ends in
:meth:`FederatedEngine.release`: the graphs and their pool go back to the
card at the run's end, not when Python collects the trainer.

``perms_for(round_idx, client, n_valid[, track])`` may supply a client's
epoch permutations (the tests feed the reference's draws; ``track`` is
``"personal"`` for Ditto's personal track, ``"first"`` and ``"tail"`` for
Sub-FedAvg's first epoch and the epochs after it, and absent otherwise);
by default they come from the trainer's generator. ``noise_for(stream,
round_idx, client, like)`` gives a client's standard normal draws for the
Gaussian attack (``"attack"``), the weak-DP defense (``"weak_dp"``) and
D-PSGD's DP transform (``"dp"``); by default each leaf's come from a
generator keyed by (seed, stream, round, rank, leaf), and the tests set the
reference's draws.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Iterator, NamedTuple

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.codec import device as codec_device
from neuroimagedisttraining_tpu_torch.codec import wire as codec_wire
from neuroimagedisttraining_tpu_torch.config import ExperimentConfig
from neuroimagedisttraining_tpu_torch.core import robust
from neuroimagedisttraining_tpu_torch.core.losses import binary_auc
from neuroimagedisttraining_tpu_torch.core.optim import round_lr
from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
from neuroimagedisttraining_tpu_torch.data.federate import FederatedData
from neuroimagedisttraining_tpu_torch.faults import adversary
from neuroimagedisttraining_tpu_torch.faults.schedule import (
    FaultSchedule, parse_fault_spec,
)
from neuroimagedisttraining_tpu_torch.engines import program as round_program
from neuroimagedisttraining_tpu_torch.obs import actions as obs_actions
from neuroimagedisttraining_tpu_torch.obs import compute as obs_compute
from neuroimagedisttraining_tpu_torch.obs import flight as obs_flight
from neuroimagedisttraining_tpu_torch.obs import health as obs_health
from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
from neuroimagedisttraining_tpu_torch.obs import names as obs_names
from neuroimagedisttraining_tpu_torch.obs import rules as obs_rules
from neuroimagedisttraining_tpu_torch.obs import trace as obs_trace
from neuroimagedisttraining_tpu_torch.ops import mpc_device
from neuroimagedisttraining_tpu_torch.ops.masks import mask_nnz
from neuroimagedisttraining_tpu_torch.parallel import cohort
from neuroimagedisttraining_tpu_torch.utils import checkpoint as ckpt
from neuroimagedisttraining_tpu_torch.utils.logging import (
    ExperimentLogger, publish_registry,
)
from neuroimagedisttraining_tpu_torch.utils.pytree import tree_clone
from neuroimagedisttraining_tpu_torch.weights import (
    flax_named_leaves, state_from_flax, state_to_flax,
)

State = dict[str, torch.Tensor]

log = logging.getLogger(__name__)

#: the noise streams of ``noise_for``
NOISE_STREAMS = robust.NOISE_STREAMS


def _capable(flag: str) -> list[str]:
    """The engines whose class sets ``flag``, by name."""
    from neuroimagedisttraining_tpu_torch.engines import ENGINES

    return sorted({c.name for c in ENGINES.values() if getattr(c, flag)})


class ClientRows(NamedTuple):
    """One client's rows of a split: ``X[Nmax, ...]`` (uint8 volumes or
    float32 images), ``y[Nmax]`` int32 (zero past ``n``) and the true count
    ``n``."""

    X: torch.Tensor
    y: torch.Tensor
    n: int


class FederatedEngine:
    """Shared state and helpers of a federated run."""

    name = "base"
    #: the round's uploads go through the attack stage under ``byz:``
    #: value faults
    supports_byz_faults = False
    #: the round's uploads go through the wire codec's roundtrip
    supports_wire_codec = False
    #: the codec's top-k stage keeps per-client error feedback
    wire_uses_ef = False
    #: the round applies ``--dp_clip`` / ``--dp_sigma``
    supports_dp = False
    #: the round has the default aggregation tail, which ``--secure_quant``
    #: swaps for the GF(p) fold
    supports_secure_quant = False
    #: the defenses the round can realize
    supported_defenses: tuple = ("none",)
    #: the round's local training can be split over a client mesh
    #: (``--client_mesh``)
    supports_cohort_sharding = False
    #: a streamed run can run windows (``--rounds_per_dispatch``)
    supports_fused_streaming = False
    #: a window's log line for an engine that trains every client
    cohort_label = "every client"
    #: the checkpoint's keys of the carry's slots, in order (the
    #: reference's state-dict keys); ``history`` and the engine's
    #: ``ckpt_extra`` ride beside them
    ckpt_slots: tuple[str, ...] = ()

    def __init_subclass__(cls, **kw):
        """Every engine's ``train`` ends in :meth:`release`."""
        super().__init_subclass__(**kw)
        run = cls.__dict__.get("train")
        if run is None:
            return

        @functools.wraps(run)
        def train(self, *args, **kwargs):
            out = run(self, *args, **kwargs)
            self.release()
            return out
        cls.train = train

    def release(self) -> None:
        """The end of a run: the trainer's step graphs, their static
        buffers and their capture pool go, and the cache goes back to the
        card (``LocalTrainer.release_graphs``, after a device sync). The
        engine stays usable: a later ``train()`` or resume captures
        again."""
        self.trainer.release_graphs()

    #: the round's training walk covers the sampled clients (else every
    #: client)
    trains_sampled = True
    #: the test walks an evaluation round makes, and the walks after the
    #: last round (``"train"`` a fine-tune of every client)
    eval_walks = 1
    final_walks: tuple[str, ...] = ("test",)

    def __init__(self, cfg: ExperimentConfig, data: FederatedData | None,
                 trainer: LocalTrainer, perms_for=None, stream=None,
                 mesh=None):
        """``data``: the resident federation, or None with ``stream``, a
        ``StreamingFederation``; ``mesh``: the device mesh
        (``parallel/mesh.py``), None for one device."""
        if (data is None) == (stream is None):
            raise ValueError("an engine takes its data or a stream (one "
                             "of the two)")
        self.cfg = cfg
        self.data = data
        self.stream = stream
        self.mesh = mesh
        self.trainer = trainer
        self.device = trainer.device
        src = data if data is not None else stream
        self.num_clients = int(src.num_clients)
        #: the clients' training row counts, on the host
        self.n_train = np.asarray(src.n_train, np.int64)
        self.real_clients = int(np.sum(self.n_train > 0))
        self.max_samples = (int(data.X_train.shape[1]) if data is not None
                            else int(stream.nmax_train))
        #: one sample's shape: a volume's (D, H, W), an image's (H, W, C)
        self.sample_shape = (tuple(data.X_train.shape[2:]) if data is not None
                             else tuple(stream.sample_shape))
        self._walks: list[tuple[str, tuple]] = []
        self.perms_for = perms_for
        #: the experiment log (``LOG/<dataset>/<identity>.log``), None
        #: without a log dir
        self.log = (ExperimentLogger(cfg.log_dir, cfg.data.dataset,
                                     cfg.identity())
                    if cfg.log_dir else None)
        # the reference's accounting (its stat_info): communicated
        # parameters and training FLOPs summed over rounds, non-finite
        # uploads dropped, and the accuracy at every evaluation
        self.stat_info: dict = {
            "sum_comm_params": 0.0, "sum_training_flops": 0.0,
            "sum_comm_bytes": 0.0, "sum_comm_bytes_dense": 0.0,
            "nonfinite_uploads": 0.0,
            "global_test_acc": [], "person_test_acc": [],
            "final_masks": [],
        }
        # the reflex plane's state (obs/actions.py): quarantine windows
        # (from_round, until_round) by client, the cohorts and health rows
        # the handlers look back at, the escalated defense, the healthy
        # pin and a rollback waiting for the next boundary
        self._quarantine_windows: dict[int, list[tuple[int, int]]] = {}
        self._sampled_by_round: dict[int, np.ndarray] = {}
        self._last_health_rows: dict[int, dict] = {}
        self._defense_override: str | None = None
        self._healthy_pin: dict | None = None
        self._pending_rollback: dict | None = None
        self._preempts_done: set[int] = set()
        #: the round's health stats, waiting for the round's outputs
        self._health_out: dict = {}
        #: the metrics JSONL sink's sequence and last round
        self._metrics_seq = 0
        self._metrics_last_round: int | None = None
        self._compute_armed = False
        trainer.obs_engine = self.name
        self._init_defended_round(stream)
        self._init_dispatch()

    @property
    def announce(self):
        """Where the engine's announcements go: the experiment log (its file
        and console echo) where a log dir is set, else this module's
        logger."""
        return self.log if self.log is not None else log

    def _init_dispatch(self) -> None:
        """The startup checks of ``--client_mesh`` and
        ``--rounds_per_dispatch``, with the reference's messages: a mesh of
        another size is an error; an engine or mode that cannot shard or
        run windows says so once, with its reason."""
        f = self.cfg.fed
        self._cohort_on = False
        cm = int(f.client_mesh)
        #: a mesh that spans ranks splits the round's clients over the
        #: ranks wherever cohort sharding would run on its entries (a
        #: two-level mesh included); elsewhere each rank runs it all
        self._rank_split = (self.mesh is not None
                            and self.mesh.num_processes > 1
                            and self.program.cohort_fallback_key(flat=True)
                            is None)
        if self._rank_split:
            self.announce.info(
                "mesh of %d processes: rank %d trains the clients of its "
                "%d of the %d entries in its turn; the ranks hand on the "
                "trained states and the generator's state every round "
                "(parallel/cohort.py)",
                self.mesh.num_processes, self.mesh.process_id,
                len(self.mesh.local_entries), self.mesh.devices.size)
        if cm > 0:
            mesh = self.mesh
            if mesh is None:
                raise ValueError(
                    f"--client_mesh {cm} requested but no device mesh was "
                    "constructed — build the engine with a mesh (the CLIs "
                    "do this automatically; tests: make_mesh())")
            if cm != mesh.devices.size:
                raise ValueError(
                    f"--client_mesh {cm} does not match the constructed "
                    f"{mesh.devices.size}-device mesh; pass a matching "
                    "--client_mesh / --mesh_shape / --virtual_devices "
                    "combination (the sampled-client axis shards over "
                    "EVERY mesh device)")
            key = self.program.cohort_fallback_key()
            if key is None:
                self._cohort_on = True
                self.announce.info(
                    "client_mesh=%d: cohort sharding armed — the sampled-"
                    "client axis of every round shards over the "
                    "%d-device mesh (pad rows zero-weighted; "
                    "parallel/cohort.py)", cm, mesh.devices.size)
            else:
                round_program.report_fallback(
                    self.name, key, "client_mesh=%d requested; running the "
                    "unsharded round program", cm, sink=self.log)
        if f.rounds_per_dispatch > 1:
            key = self.fused_fallback_key()
            if key is not None:
                round_program.report_fallback(
                    self.name, key, "rounds_per_dispatch=%d requested; "
                    "dispatching one round at a time",
                    f.rounds_per_dispatch, sink=self.log)

    # ---------- the round program (engines/program.py) ----------

    @property
    def program(self) -> round_program.RoundProgram:
        """The engine's planner and window runner, made at first use."""
        prog = self.__dict__.get("_program")
        if prog is None:
            prog = self._program = round_program.RoundProgram(
                self, self.round_stages())
        return prog

    def round_stages(self) -> round_program.RoundStages | None:
        """The engine's declared round, or None where its rounds keep
        host-side state between them (no windows, no sharding)."""
        return None

    def fused_fallback_key(self) -> str | None:
        """Why the engine runs one round at a time under
        ``--rounds_per_dispatch K``: a ``REASONS`` key, or None."""
        return self.program.fused_fallback_key()

    def cohort_fallback_key(self) -> str | None:
        """Why an engine without a sharded round runs unsharded under
        ``--client_mesh``; engines with their own story override."""
        return "no-sharded-body"

    # ---------- checkpoints (utils/checkpoint.py) ----------

    def _ckpt_active(self) -> bool:
        return bool(self.cfg.checkpoint_dir) and self.cfg.checkpoint_every > 0

    def _leaf_shapes(self) -> dict[str, tuple]:
        model = self.trainer.model
        return {k: tuple(v.shape) for k, v in
                [*model.named_parameters(), *model.named_buffers()]}

    def _ckpt_encode(self, state: dict) -> dict:
        """The state with its model states as the reference's flax trees
        (a list of one a client stacked), tensors as arrays."""
        buffers = {k for k, _ in self.trainer.model.named_buffers()}
        out = {}
        for k, v in state.items():
            st = v[0] if isinstance(v, list) and v and isinstance(
                v[0], dict) else v
            if isinstance(st, dict) and st and all(
                    isinstance(x, torch.Tensor) for x in st.values()):
                out[k] = state_to_flax(v, stats=set(st) <= buffers)
            else:
                out[k] = v
        return out

    def _ckpt_decode(self, state: dict) -> dict:
        """:meth:`_ckpt_encode`'s inverse: flax trees back to the port's
        states on the device, arrays to tensors."""
        shapes = self._leaf_shapes()
        out = {}
        for k, v in state.items():
            if isinstance(v, dict) and k != "stat_info":
                out[k] = state_from_flax(v, shapes, self.device)
            elif isinstance(v, np.ndarray):
                out[k] = torch.from_numpy(v).to(self.device, copy=True)
            else:
                out[k] = v
        return out

    def maybe_checkpoint(self, round_idx: int, state: dict) -> None:
        """Save the state after round ``round_idx`` every
        ``checkpoint_every`` rounds and at the last round, with
        ``stat_info``'s numbers and lists and the trainer's generator."""
        if not self._ckpt_active():
            return
        last = round_idx == self.cfg.fed.comm_round - 1
        if (round_idx + 1) % self.cfg.checkpoint_every == 0 or last:
            state = self._ckpt_encode(state)
            state["stat_info"] = {
                k: v for k, v in self.stat_info.items()
                if isinstance(v, (int, float, list))}
            state["generator"] = self.trainer.generator
            with obs_trace.span("checkpoint", round=round_idx):
                path = ckpt.save_checkpoint(self.cfg.checkpoint_dir,
                                            round_idx, state)
            self.announce.info("checkpoint saved: round %d -> %s", round_idx,
                               path)

    def restore_checkpoint(self) -> tuple[int, dict | None]:
        """``(start_round, state)``: the round to resume at and the state
        of the last completed round, or ``(0, None)``. ``stat_info`` and
        the trainer's generator are restored here."""
        if not self._ckpt_active():
            return 0, None
        loaded = ckpt.load_checkpoint(self.cfg.checkpoint_dir)
        if loaded is None:
            return 0, None
        round_idx, state = loaded
        self.stat_info.update(state.pop("stat_info", {}))
        gen = state.pop("generator", None)
        if gen is not None:
            self.trainer.generator.set_state(gen)
        self.announce.info("resuming from checkpoint: round %d", round_idx + 1)
        return round_idx + 1, self._ckpt_decode(state)

    def ckpt_extra(self) -> dict:
        """State beside the carry that a checkpoint holds (SalientGrads'
        mask)."""
        return {}

    def restore_extra(self, state: dict) -> None:
        """Take :meth:`ckpt_extra`'s entries back from a restored state."""

    def ckpt_state(self, carry: tuple, history: list) -> dict:
        return {**dict(zip(self.ckpt_slots, carry)), **self.ckpt_extra(),
                "history": history}

    def carry_from(self, state: dict) -> tuple:
        """The carry of a restored state (and its extra entries taken)."""
        self.restore_extra(state)
        return tuple(state[k] for k in self.ckpt_slots)

    def resume(self, start_carry: tuple, history: list
               ) -> tuple[int, tuple]:
        """``(start_round, carry)``: the newest checkpoint's, its history
        put into ``history``, or ``(0, start_carry)``."""
        start, restored = self.restore_checkpoint()
        if restored is None:
            return 0, start_carry
        history[:] = restored["history"]
        return start, self.carry_from(restored)

    def _fuse(self) -> bool:
        return (self.cfg.fed.rounds_per_dispatch > 1
                and self.fused_fallback_key() is None)

    def _cohort_pad(self, sampled) -> tuple[np.ndarray, int]:
        """``(padded_ids, n_real)``: the sampled set padded to tile the
        client mesh (``parallel/cohort.py`` ``pad_cohort``)."""
        return cohort.pad_cohort(np.asarray(sampled), self.real_clients,
                                 self.num_clients, self.mesh.devices.size)

    def map_clients(self, fn, ids) -> list:
        """``fn(c, rows)`` for each client of ``ids`` with its training
        rows, in client order. With cohort sharding armed the clients
        (padded to tile the mesh where the round trains a sampled set) are
        split over the mesh's entries (``cohort.cohort_map``); a pad row
        trains nothing and is dropped, so the list is ``ids``'. On a mesh
        that spans ranks each rank trains its own entries' clients (a
        two-level mesh's entries row-major, as its silo-first mean cuts
        them), in turns that hand the trainer generator's state from rank
        to rank, and receives the others' trained states."""
        ids = np.asarray(ids)
        if not (self._cohort_on or self._rank_split):
            return [fn(c, rows) for c, rows in self.client_rows(ids)]
        if self.program.stages.gathers_cohort:
            padded, n_real = self._cohort_pad(ids)
        else:
            padded, n_real = ids, len(ids)
        rows = dict(self.client_rows(ids))
        live = cohort.pad_row_weights(torch.ones(len(padded)), n_real) > 0
        items = [(int(c), rows[int(c)] if live[i] else None)
                 for i, c in enumerate(padded)]
        out = cohort.cohort_map(
            self.mesh.flat(), lambda it: None if it[1] is None else fn(*it),
            items, self.device, generator=self.trainer.generator)
        return out[:n_real]

    # ---------- the round loop with windows ----------

    def window_round(self, carry: tuple, round_idx: int, sampled):
        """One round of the engine's declared round from ``carry``:
        ``(carry, outs)``, ``outs`` a dict of device scalars (``loss``,
        and ``n_bad`` where the round counts non-finite uploads). Engines
        that declare ``round_stages`` implement it."""
        raise NotImplementedError

    def run_rounds(self, carry: tuple, on_round, history: list | None = None,
                   start: int = 0) -> tuple:
        """Every round from round ``start`` and ``carry``: one at a time,
        or in windows under ``--rounds_per_dispatch``. After each round's
        outputs are read, ``on_round(r, carry, row, seconds, sampled)``
        runs in round order (``row``: the round's outputs as host floats;
        ``carry``: the state after the window, which is the round's own
        for the window's last round, the only one that can be hooked;
        ``seconds``: the window's time shared by its rounds). Each
        window's end is a host boundary: the stats, the rules and the
        reflexes, then the checkpoint of the carry (under
        :attr:`ckpt_slots`) with ``history``. A preemption resumes from
        the last checkpoint (:attr:`takes_preempt`). Returns the last
        carry."""
        f = self.cfg.fed
        fuse = self._fuse()
        self._arm_compute_profiler()
        history = [] if history is None else history
        r = start
        while r < f.comm_round:
            pre = self._maybe_preempt(r) if self.takes_preempt else None
            if pre is not None:
                fuse = self._fuse()
                if pre[1] is not None:
                    r, restored = pre
                    history[:] = restored["history"]
                    carry = self.carry_from(restored)
                    continue
            k = self.program.dispatch_window(r) if fuse else 1
            label = "window" if k > 1 else "round"
            built = self.program.built
            t0 = time.perf_counter()
            with obs_trace.span(label, engine=self.name, round=r, rounds=k):
                if k > 1:
                    carry, outs, wi = self.program.run_window(carry, r, k)
                    k, sampled = wi.k, wi.sampled
                else:
                    self.plan_walks(r)
                    s = self.round_sampling(r)
                    carry, o = self.window_round(carry, r, s)
                    outs, sampled = [{**o, **self.take_health()}], [s]
            obs_compute.note_dispatch(
                self.name, label, time.perf_counter() - t0, rounds=k,
                phase="compile" if self.program.built > built else "execute")
            with obs_trace.span("flush", engine=self.name,
                                round=r + k - 1):
                rows = self.read_outs(r, outs)
            self._sync()
            dt = (time.perf_counter() - t0) / k
            for off, row in enumerate(rows):
                on_round(r + off, carry, row, dt,
                         sampled[off] if sampled is not None else None)
            last = r + k - 1
            self.publish_stat_info(last)
            carry = self.reflex_carry(last, carry)
            self.maybe_checkpoint(last, self.ckpt_state(carry, history))
            r += k
        return carry

    def take_health(self) -> dict:
        """The round's health stats (device tensors) its tail left, taken
        once."""
        out, self._health_out = self._health_out, {}
        return out

    @property
    def health_on(self) -> bool:
        """``--health_stats`` on an engine with a declared round."""
        return bool(self.cfg.health_stats) and \
            self.program.stages is not None

    def note_health(self, stats: dict) -> None:
        """Queue health stats of the running round (read with its
        outputs)."""
        if self.health_on:
            self._health_out.update(stats)

    def round_sampling(self, round_idx: int):
        """A single round's cohort, logged (None for an engine that trains
        every client)."""
        sampled = self.client_sampling(round_idx)
        self.announce.info("round %d: clients %s", round_idx, sampled.tolist())
        return sampled

    def read_host(self, values: list[torch.Tensor]) -> list:
        """The host's read of device values: one device read for the whole
        list (a window's, or a round's); a scalar comes back as a float, a
        vector as a list of floats."""
        flat = torch.cat([v.to(torch.float64).reshape(-1)
                          for v in values]).tolist()
        out, i = [], 0
        for v in values:
            n = v.numel()
            out.append(flat[i] if v.dim() == 0 else flat[i:i + n])
            i += n
        return out

    def read_outs(self, round_idx: int, outs: list[dict]) -> list[dict]:
        """Rounds ``round_idx ..``'s outputs on the host in one read; each
        round's non-finite uploads go into ``stat_info`` with a warning,
        the privacy ledger is charged through the last round, and each
        round's health stats (``h_*``) are published (every round but the
        last also gets its metrics record and rule evaluation here; the
        last gets them at :meth:`publish_stat_info`)."""
        names = [list(o) for o in outs]
        flat = self.read_host([v for o in outs for v in o.values()])
        rows, i = [], 0
        last = round_idx + len(outs) - 1
        for r, keys in enumerate(names):
            row = dict(zip(keys, flat[i:i + len(keys)]))
            i += len(keys)
            bad = row.get("n_bad", 0.0)
            if bad:
                self.stat_info["nonfinite_uploads"] += bad
                self.announce.warning("round %d: %d non-finite uploads %s",
                                      round_idx + r, int(bad),
                                      "dropped" if self.sq_spec is None else
                                      "folded as the zero residue")
            health = {k: row.pop(k) for k in keys if k.startswith("h_")}
            if health:
                obs_health.publish_round_stats(self.name, round_idx + r,
                                               health)
                self._stash_bounded(self._last_health_rows,
                                    round_idx + r, health)
                if round_idx + r < last:
                    self._dump_metrics_jsonl(round_idx + r)
                    obs_rules.observe_boundary(round_idx + r)
            rows.append(row)
        self.record_privacy(last)
        return rows

    def _init_defended_round(self, stream) -> None:
        """The fault schedule, the privacy ledger and the wire codec's
        state; what this engine cannot run (a fault, defense, DP or codec
        flag) fails here, at startup, with the reference's messages."""
        f = self.cfg.fed
        spec = parse_fault_spec(f.fault_spec) if f.fault_spec else None
        self.fault_schedule = (FaultSchedule(spec, self.cfg.seed)
                               if spec is not None and spec.any_faults
                               else None)
        if spec is not None and spec.any_value_faults \
                and not self.supports_byz_faults:
            raise ValueError(
                f"algorithm {self.name!r} does not simulate byz: value "
                "faults (its round program does not route client "
                "uploads through faults/adversary.py, so the spec "
                f"would silently run attack-free); supported: "
                f"{_capable('supports_byz_faults')}")
        robust.validate_defense(f.defense_type)
        if f.defense_type not in self.supported_defenses:
            raise ValueError(
                f"algorithm {self.name!r} does not support --defense "
                f"{f.defense_type!r}; this engine supports: "
                f"{', '.join(self.supported_defenses)}")
        if f.defense_type in robust.ROBUST_AGGREGATORS:
            robust._check_f(f.client_num_per_round, f.byz_f, f.defense_type)
        if f.dp_sigma < 0 or f.dp_clip < 0:
            raise ValueError(
                f"dp_sigma/dp_clip must be >= 0 (got "
                f"{f.dp_sigma}/{f.dp_clip})")
        if f.dp_sigma > 0 and f.dp_clip <= 0:
            raise ValueError(
                "--dp_sigma needs --dp_clip > 0: the clip bound IS the "
                "sensitivity the noise multiplier is stated against "
                "(privacy/accountant.py)")
        if (f.dp_sigma > 0 or f.dp_clip > 0) and not self.supports_dp:
            raise ValueError(
                f"algorithm {self.name!r} does not apply the "
                "--dp_clip/--dp_sigma round-level DP transform (its "
                "round program would train un-noised while the "
                f"accountant reported epsilon); supported: "
                f"{_capable('supports_dp')}")
        #: the RDP ledger of the armed noise path (``record_privacy``)
        self._dp_rdp = None
        self._dp_recorded_through = -1
        self.wire_spec = codec_wire.parse_wire_spec(f.wire_codec,
                                                    f.wire_topk_ratio)
        if self.wire_spec is not None and not self.supports_wire_codec:
            raise ValueError(
                f"algorithm {self.name!r} does not simulate --wire_codec "
                "(its round program does not pass client uploads through "
                "the codec roundtrip, so the flag would silently train "
                f"dense); supported: {_capable('supports_wire_codec')}")
        if self.wire_spec is not None and stream is not None:
            raise ValueError(
                "--wire_codec simulates the encoded wire on the "
                "device-resident path only; streaming rounds (--streaming) "
                "keep the dense aggregation")
        #: each client's error feedback (top-k codec), made at first use
        self._wire_ef: dict[int, State] = {}
        self._dense_upload_nbytes: int | None = None
        #: secure quantized aggregation: the field, the static weight shift
        #: and the leaf scales of the initial model (None: off)
        self.sq_spec, self.sq_weight_shift, self.sq_scales = None, 0, None
        if f.secure_quant:
            self._init_secure_quant()

    def _init_secure_quant(self) -> None:
        """``--secure_quant``'s startup checks, with the reference's
        messages: the engine must have the default tail, neither the codec
        nor an order-statistic defense may be armed, the field must have
        the headroom for the cohort (``check_headroom``), and the largest
        weight shift ``s <= WEIGHT_FRAC_BITS`` with ``cohort * 2^s`` below
        the field's fold capacity is chosen once for the run. The leaf
        scales come from the initial model (parameters and BatchNorm
        statistics), read once here."""
        from neuroimagedisttraining_tpu_torch.privacy.secure_quant import (
            WEIGHT_FRAC_BITS, QuantSpec, check_headroom, leaf_scales,
            weighted_fold_capacity,
        )

        f = self.cfg.fed
        if not self.supports_secure_quant:
            raise ValueError(
                f"algorithm {self.name!r} does not simulate "
                "--secure_quant: its round has no default "
                "server-side aggregation tail for the field fold to "
                f"replace; supported: {_capable('supports_secure_quant')}")
        if self.wire_spec is not None:
            raise ValueError(
                "--secure_quant does not compose with --wire_codec: "
                "the codec's float stages would corrupt the GF(p) "
                "residue embedding (field-element frames, not model "
                "floats)")
        if f.defense_type in robust.ROBUST_AGGREGATORS:
            raise ValueError(
                f"--defense {f.defense_type} does not compose "
                "with --secure_quant (no per-client plaintext to "
                "select over); the clip family (norm_diff_clipping, "
                "weak_dp) composes CLIENT-side pre-quantize")
        spec = QuantSpec.from_bits(f.secure_quant_field_bits,
                                   f.secure_quant_frac_bits)
        check_headroom(spec, f.client_num_per_round)
        cap = weighted_fold_capacity(spec)
        cohort = max(1, int(f.client_num_per_round))
        shift = next((s for s in range(WEIGHT_FRAC_BITS, -1, -1)
                      if cohort * (1 << s) < cap), None)
        if shift is None:
            raise ValueError(
                f"--secure_quant field too small for the in-process "
                f"integer-weight fold: a {cohort}-client cohort "
                f"exceeds the {f.secure_quant_field_bits}-bit "
                f"field's capacity of {cap:.1f} weight units — pass "
                "--secure_quant_field_bits 32")
        self.sq_spec, self.sq_weight_shift = spec, shift
        params, bstats = self.init_global_state()
        self.sq_scales = leaf_scales({
            k: v.detach().cpu().numpy() for k, v in {**params,
                                                     **bstats}.items()})

    # ---------- state ----------

    def init_global_state(self) -> tuple[State, State]:
        """Initial ``(params, bstats)`` from a CPU generator seeded with
        ``cfg.seed`` (the same values on every device)."""
        model = self.trainer.model
        gen = torch.Generator().manual_seed(self.cfg.seed)
        model.to("cpu")
        model.reset_parameters(gen)
        model.to(self.device)
        params = {k: v.detach().clone() for k, v in model.named_parameters()}
        bstats = {k: v.clone() for k, v in model.named_buffers()}
        return params, bstats

    def start_state(self, init_state=None) -> tuple[State, State]:
        """The run's initial ``(params, bstats)`` on the device: the given
        ``init_state``, or :meth:`init_global_state`."""
        if init_state is None:
            return self.init_global_state()
        return tuple({k: v.to(self.device) for k, v in st.items()}
                     for st in init_state)

    @staticmethod
    def broadcast_states(params: State, bstats: State, n: int
                         ) -> tuple[list[State], list[State]]:
        """``n`` per-client copies of one state: the personal models. Each
        client owns its tensors (none is shared between clients)."""
        return ([{k: v.clone() for k, v in params.items()} for _ in range(n)],
                [{k: v.clone() for k, v in bstats.items()} for _ in range(n)])

    # ---------- sampling ----------

    def client_sampling(self, round_idx: int) -> np.ndarray:
        """All real clients, or ``np.random.seed(round_idx)`` then a choice
        without replacement: the reference's sampling, whose global-stream
        reseed keeps the cohorts identical to the reference run."""
        total = self.real_clients
        per_round = min(self.cfg.fed.client_num_per_round, total)
        if total == per_round:
            sampled = np.arange(total)
        else:
            np.random.seed(round_idx)  # nidt: allow[determinism-global-random] -- reference-parity shim (fedavg_api.py:92-100)
            sampled = np.sort(np.random.choice(range(total), per_round,  # nidt: allow[determinism-global-random] -- reference-parity shim (fedavg_api.py:92-100)
                                               replace=False))
        if self.fault_schedule is not None:
            # crashed clients (rank = index + 1) leave the cohort; the
            # weighted mean over the survivors re-weights by sample count
            sampled = self.fault_schedule.survivors(round_idx, sampled)
        if self._quarantine_windows:
            # quarantined clients leave the cohort as a crash does, unless
            # none would be left
            keep = np.asarray([not self._is_quarantined(int(c), round_idx)
                               for c in np.asarray(sampled)], bool)
            if keep.any():
                sampled = np.asarray(sampled)[keep]
        self._stash_bounded(self._sampled_by_round, int(round_idx),
                            np.asarray(sampled))
        if len(sampled) == 0:
            raise ValueError(
                f"round {round_idx}: the sampled client set is empty — "
                f"client_num_per_round={per_round} and the fault "
                f"schedule ({self.cfg.fed.fault_spec!r}) left no "
                "survivors; raise --frac / --client_num_in_total or "
                "reduce the crash coverage in --fault_spec")
        return sampled

    def round_lr(self, round_idx: int) -> torch.Tensor:
        return round_lr(self.cfg.optim, round_idx, self.device)

    # ---------- client rows ----------

    def _eval_chunk_size(self) -> int:
        """Clients a streamed chunk holds: ``stream_chunk_clients``, or the
        mesh's entries (so a chunk tiles the mesh), or 4."""
        if self.cfg.stream_chunk_clients:
            return self.cfg.stream_chunk_clients
        return self.mesh.devices.size if self.mesh is not None else 4

    def _resident(self, split: str):
        d = self.data
        return {"train": (d.X_train, d.y_train, d.n_train),
                "test": (d.X_test, d.y_test, d.n_test),
                "val": (d.X_val, d.y_val, d.n_val)}[split]

    def client_rows(self, ids, split: str = "train"
                    ) -> Iterator[tuple[int, ClientRows]]:
        """Each client of ``ids``, in order, with its rows of ``split``:
        slices of the resident stacks, or the client's rows in the current
        streamed chunk (valid until the walk moves on to the next chunk)."""
        if self.stream is None:
            X, y, n = self._resident(split)
            for c in ids:
                c = int(c)
                yield c, ClientRows(X[c], y[c], int(n[c]))
            return
        window = self._round_rows
        if window is not None and split == "train" and all(
                int(c) in window for c in ids):
            for c in ids:
                yield int(c), window[int(c)]
            return
        walk = (split, tuple(int(c) for c in ids))
        if self._walks and self._walks[0] == walk:
            self._walks.pop(0)
        else:
            self._walks = []
        then = ((np.asarray(self._walks[0][1]), self._walks[0][0])
                if self._walks else None)
        n = getattr(self.stream, f"n_{split}")
        for ch in self.stream.eval_chunks(self._eval_chunk_size(), split,
                                          ids=walk[1], then=then):
            for j, c in enumerate(ch.ids):
                yield int(c), ClientRows(ch.X[j], ch.y[j], int(n[c]))

    #: a streamed window's rows of the round being trained (client ->
    #: rows), which ``client_rows`` serves its training walk from
    _round_rows: dict | None = None

    def plan_walks(self, round_idx: int, before=()) -> None:
        """Streamed runs: the walks from round ``round_idx`` on that the
        feed may prefetch for (``before`` first): the round's training
        walk, its evaluations, then the next round's training walk, or
        after the last round the ``final_walks``. A walk the plan did not
        foresee is read without a prefetch, and as right."""
        if self.stream is None:
            return
        everyone = tuple(range(self.num_clients))

        def train_walk(r):
            ids = self.client_sampling(r) if self.trains_sampled else everyone
            return ("train", tuple(int(c) for c in ids))

        walks = [*before, train_walk(round_idx)]
        if self.is_eval_round(round_idx):
            walks += [("test", self.eval_ids())] * self.eval_walks
        if round_idx + 1 < self.cfg.fed.comm_round:
            walks.append(train_walk(round_idx + 1))
        else:
            walks += [(split, self.eval_ids() if split == "test"
                       else everyone) for split in self.final_walks]
        self._walks = walks

    # ---------- local training ----------

    def client_train(self, round_idx: int, c: int, rows: ClientRows,
                     params: State, bstats: State, lr, epochs: int,
                     track: str = "global", **kw):
        """Local SGD of client ``c`` from ``(params, bstats)`` on its
        training ``rows``: ``(params, bstats, mean_loss)``. ``track`` names
        the run to ``perms_for``; ``kw`` goes to ``local_train``
        (``mask``, ``prox_lamda``, ``prox_ref``, ``momentum``)."""
        n = rows.n
        perms = None
        if self.perms_for is not None:
            perms = (self.perms_for(round_idx, c, n) if track == "global"
                     else self.perms_for(round_idx, c, n, track))
        return self.trainer.local_train(
            params, bstats, rows.X, rows.y, n, lr, epochs,
            self.cfg.optim.batch_size, self.max_samples, perms=perms, **kw)

    def train_sampled(self, round_idx: int, params: State, bstats: State,
                      sampled, lr, **kw):
        """The sampled clients train from the global model for ``epochs``.
        Returns their ``(params, bstats)`` lists and their losses
        ``[S]``."""
        out = self.map_clients(
            lambda c, rows: self.client_train(round_idx, c, rows, params,
                                              bstats, lr,
                                              self.cfg.optim.epochs, **kw),
            sampled)
        ups_p, ups_b, losses = map(list, zip(*out))
        return ups_p, ups_b, torch.stack(losses)

    def train_and_aggregate(self, round_idx: int, params: State,
                            bstats: State, sampled, lr, **kw):
        """The sampled clients train from the global model for ``epochs``;
        the round's tail (:meth:`defended_aggregate`). Returns ``(params,
        bstats, loss, n_bad, uploads)``, ``uploads`` the clients' honest
        ``(params, bstats)`` lists (before any attack or codec)."""
        ups_p, ups_b, losses = self.train_sampled(round_idx, params, bstats,
                                                  sampled, lr, **kw)
        ns = self.to_device(self.n_train[sampled])
        new_p, new_b, loss, n_bad = self.defended_aggregate(
            round_idx, sampled, ups_p, ups_b, params, bstats, ns, losses)
        return new_p, new_b, loss, n_bad, (ups_p, ups_b)

    # ---------- host boundaries ----------

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device, copied without a stream sync (the
        copy from pageable memory is staged before the call returns)."""
        return torch.from_numpy(np.asarray(a)).to(self.device,
                                                  non_blocking=True)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------- the host boundary's telemetry (obs/) ----------

    def _arm_compute_profiler(self) -> None:
        """Arm the MFU accounting once: the analytic training FLOPs of a
        nominal round (a sample's, times the expected sampled samples,
        times the epochs) against the card's peak in the run's
        precision. A model the counter cannot walk leaves MFU
        unpublished."""
        if self._compute_armed:
            return
        self._compute_armed = True
        try:
            per_sample = obs_compute.analytic_sample_flops(
                self.trainer, self.sample_shape)
            frac = (min(self.cfg.fed.client_num_per_round,
                        self.real_clients) / max(1, self.real_clients))
            per_round = (per_sample * float(np.sum(self.n_train)) * frac
                         * max(1, self.cfg.optim.epochs))
            obs_compute.arm_model(
                self.name, per_round, precision=self.cfg.optim.precision,
                device_name=None if self.device.type == "cuda" else "cpu")
        except Exception as e:  # noqa: BLE001 — MFU is best-effort
            self.announce.info("compute profiler: analytic FLOPs unavailable "
                               "for this model (%s); nidt_mfu stays "
                               "unpublished", e)

    def _dump_metrics_jsonl(self, round_idx: int) -> None:
        """One registry record a round into ``--metrics_out``, with the
        ``round`` and a monotonic ``seq``; a round already written is
        not written again."""
        path = self.cfg.metrics_out
        if not path:
            return
        if self._metrics_last_round is not None \
                and round_idx <= self._metrics_last_round:
            return
        self._metrics_seq += 1
        self._metrics_last_round = int(round_idx)
        obs_metrics.REGISTRY.dump_jsonl(
            path, round=int(round_idx), seq=self._metrics_seq,
            engine=self.name)

    def publish_stat_info(self, round_idx: int) -> None:
        """The host boundary after round ``round_idx``: ``stat_info``'s
        numbers and the DP ledger's epsilon (and its last round's burn) as
        gauges, the round gauge, the compute profiler's MFU window, the
        metrics record and the rules' evaluation."""
        g = obs_metrics.gauge(
            obs_names.STAT, "engine stat_info accumulators "
            "(engines/base.py), one series per key", labelnames=("key",))
        for k, v in self.stat_info.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                g.labels(key=k).set(float(v))
        for src in ("weak_dp", "dp"):
            d = self.stat_info.get(src)
            if isinstance(d, dict) and d.get("epsilon_per_round"):
                obs_metrics.gauge(
                    obs_names.DP_EPSILON,
                    "running (epsilon, delta) privacy cost of the armed "
                    "noise path (privacy/accountant.py)",
                    labelnames=("source",)).labels(source=src).set(
                    float(d["epsilon"]))
                per = d["epsilon_per_round"]
                burn = (per[-1] - per[-2]) if len(per) > 1 else per[-1]
                obs_metrics.gauge(
                    obs_names.DP_EPSILON_PER_ROUND,
                    "epsilon spent by the last accounted round (the "
                    "budget burn rate --dp_epsilon_budget is judged "
                    "against)", labelnames=("source",)).labels(
                    source=src).set(float(burn))
        obs_metrics.gauge(
            obs_names.ENGINE_ROUND,
            "last round index flushed at an engine host boundary",
        ).set(int(round_idx))
        obs_compute.PROFILER.boundary(self.name)
        self._dump_metrics_jsonl(round_idx)
        obs_rules.observe_boundary(round_idx)

    # ---------- the reflex plane (obs/actions.py) ----------

    #: rounds of the host stashes the handlers look back at
    _REFLEX_STASH_CAP = 64
    #: rounds a quarantine lasts
    _REFLEX_QUARANTINE_ROUNDS = 5
    #: the escalation ladder, each rung stronger
    _DEFENSE_LADDER = ("none", "norm_diff_clipping", "trimmed_mean")
    #: the round's global model is the carry's first two slots, which a
    #: rollback restores (the FedAvg family)
    rollback_slots = False
    #: ``preempt:`` faults shrink the mesh between this engine's rounds;
    #: as in the reference, only the FedAvg family takes them (the other
    #: engines run the spec's other faults and ignore ``preempt:``)
    takes_preempt = False

    @staticmethod
    def _stash_bounded(d: dict, key: int, value) -> None:
        d[key] = value
        while len(d) > FederatedEngine._REFLEX_STASH_CAP:
            d.pop(min(d))

    def _is_quarantined(self, client: int, round_idx: int) -> bool:
        return any(a <= round_idx < b
                   for a, b in self._quarantine_windows.get(client, ()))

    def active_defense(self) -> str:
        """The defense the round runs now: the flag's, or the escalated
        one."""
        return self._defense_override or self.cfg.fed.defense_type

    def _invalidate_round_programs(self) -> None:
        """Drop the planner and the trainer's step graphs: the next round
        plans and captures again against the engine's state now."""
        self.__dict__.pop("_program", None)
        self.trainer.drop_graphs()

    def _register_reflexes(self) -> None:
        """Register the engine's handlers on the armed action bus (none
        armed: nothing)."""
        bus = obs_actions.active()
        if bus is None:
            return
        bus.register("quarantine_silo", self._act_quarantine)
        bus.register("escalate_defense", self._act_escalate_defense)
        bus.register("freeze_rollback", self._act_freeze_rollback)

    def _act_quarantine(self, *, rule: str, round_idx: int | None,
                        value=None) -> dict:
        """quarantine_silo: the sampled client of the firing round with the
        lowest leave-one-out cosine leaves the cohort for
        ``_REFLEX_QUARANTINE_ROUNDS`` rounds from the next; at most
        ``byz_f`` clients at once."""
        r = -1 if round_idx is None else int(round_idx)
        sampled = self._sampled_by_round.get(r)
        row = self._last_health_rows.get(r)
        cos = None if row is None else row.get("h_cos")
        if sampled is None or cos is None:
            return {"status": "skipped",
                    "reason": "no per-client cosine row for the round "
                              "(--health_stats off, or pre-health "
                              "boundary)"}
        cos = np.ravel(np.asarray(cos, np.float64))
        n = min(len(sampled), cos.size)
        if n == 0:
            return {"status": "skipped", "reason": "empty cohort"}
        offender = int(np.asarray(sampled)[int(np.argmin(cos[:n]))])
        if self._is_quarantined(offender, r + 1):
            return {"status": "skipped", "client": offender,
                    "reason": "offender already quarantined"}
        cap = max(1, int(self.cfg.fed.byz_f))
        active_now = sum(1 for c in self._quarantine_windows
                         if self._is_quarantined(c, r + 1))
        if active_now >= cap:
            return {"status": "skipped",
                    "reason": f"quarantine cap {cap} (byz_f) reached"}
        until = r + 1 + self._REFLEX_QUARANTINE_ROUNDS
        self._quarantine_windows.setdefault(offender, []).append(
            (r + 1, until))
        self.announce.warning(
            "reflex: client %d quarantined rounds [%d, %d) (rule %s, min "
            "leave-one-out cosine %.3f)", offender, r + 1, until, rule,
            float(cos[:n].min()))
        return {"client": offender, "from_round": r + 1, "until": until,
                "cos": float(cos[:n].min())}

    def _act_escalate_defense(self, *, rule: str, round_idx: int | None,
                              value=None) -> dict:
        """escalate_defense: one rung up the ladder; what cannot be
        escalated is a skipped dispatch with its reason."""
        cur = self.active_defense()
        ladder = self._DEFENSE_LADDER
        if self.cfg.fed.secure_quant:
            return {"status": "skipped",
                    "reason": "secure_quant rounds have no plaintext "
                              "defend tail to escalate"}
        if cur not in ladder:
            return {"status": "skipped",
                    "reason": f"operator defense {cur!r} is outside "
                              "the escalation ladder"}
        if cur == ladder[-1]:
            return {"status": "skipped",
                    "reason": f"already at the top rung {cur!r}"}
        nxt = ladder[ladder.index(cur) + 1]
        if nxt not in self.supported_defenses:
            return {"status": "skipped",
                    "reason": f"engine {self.name!r} does not support "
                              f"{nxt!r}"}
        if nxt in robust.ROBUST_AGGREGATORS:
            try:
                robust._check_f(self.cfg.fed.client_num_per_round,
                                self.cfg.fed.byz_f, nxt)
            except ValueError as e:
                return {"status": "skipped", "reason": str(e)}
        self._defense_override = nxt
        self._invalidate_round_programs()
        self.announce.warning("reflex: defense escalated %s -> %s (rule %s); "
                              "the step graphs are dropped", cur, nxt, rule)
        return {"from": cur, "to": nxt}

    def _act_freeze_rollback(self, *, rule: str, round_idx: int | None,
                             value=None) -> dict:
        """freeze_rollback: the next host boundary restores the last
        healthy pin."""
        if self._healthy_pin is None:
            return {"status": "skipped",
                    "reason": "no healthy pinned state yet"}
        self._pending_rollback = {
            "rule": rule,
            "round": -1 if round_idx is None else int(round_idx)}
        return {"pin_round": int(self._healthy_pin["round"])}

    def _reflex_boundary(self, round_idx: int, params: State,
                         bstats: State) -> tuple[State, State]:
        """The boundary's reflex hook: a pending rollback restores copies
        of the pin (and zeroes the codec's error feedback, measured
        against the states it discards), else the state is pinned as
        healthy while the bus acts and the rules read ok. Pin and restore
        are copies, so neither can be changed by a later round."""
        pend = self._pending_rollback
        if pend is not None:
            self._pending_rollback = None
            pin = self._healthy_pin
            if pin is not None:
                params = tree_clone(pin["params"])
                bstats = tree_clone(pin["batch_stats"])
                self._wire_ef = {}
                self.trainer.drop_graphs()
                obs_flight.record("rollback", rule=pend.get("rule"),
                                  round=int(round_idx),
                                  pin_round=int(pin["round"]))
                self.announce.warning(
                    "reflex: rolled back to the healthy state of round %d "
                    "at boundary %d (rule %s); codec EF reset",
                    pin["round"], round_idx, pend.get("rule"))
            return params, bstats
        bus = obs_actions.active()
        if bus is not None and bus.mode == "on":
            rules_eng = obs_rules.active()
            if rules_eng is None or rules_eng.status() == "ok":
                self._healthy_pin = {"round": int(round_idx),
                                     "params": tree_clone(params),
                                     "batch_stats": tree_clone(bstats)}
        return params, bstats

    def reflex_carry(self, round_idx: int, carry: tuple) -> tuple:
        """:meth:`_reflex_boundary` on the carry's global model, for the
        engines whose rollback restores it."""
        if not self.rollback_slots:
            return carry
        params, bstats = self._reflex_boundary(round_idx, *carry[:2])
        return (params, bstats, *carry[2:])

    def _maybe_preempt(self, round_idx: int):
        """A ``preempt:NDEV@ROUND`` fault whose round has come: the mesh
        shrinks to its first NDEV entries (``--client_mesh`` follows), the
        step graphs (captured on the old entries' streams) are dropped,
        and the run resumes from the last checkpoint:
        ``(resume_round, state)``, or ``(round_idx, None)`` to go on from
        the live state. None when nothing fires. Recorded as
        ``shrink_mesh`` whatever ``--actions`` says."""
        if self.fault_schedule is None:
            return None
        hits = [(at, nd) for (at, nd) in self.fault_schedule.spec.preempts
                if at <= round_idx and at not in self._preempts_done]
        if not hits:
            return None
        at, ndev = hits[0]
        self._preempts_done.add(at)
        old = self.mesh.devices.size if self.mesh is not None else 0
        if self.mesh is None or not 0 < ndev < old:
            obs_actions.record_action(
                "shrink_mesh", rule="device-loss", round_idx=round_idx,
                status="skipped",
                detail={"reason": ("no mesh to shrink" if self.mesh is None
                                   else f"{ndev} survivors do not shrink "
                                   f"the {old}-device mesh"),
                        "scheduled_round": int(at)})
            return None
        self.mesh = self.mesh.first(ndev)
        if int(self.cfg.fed.client_mesh) > 0:
            self.cfg = dataclasses.replace(
                self.cfg, fed=dataclasses.replace(self.cfg.fed,
                                                  client_mesh=ndev))
        self._invalidate_round_programs()
        if self._cohort_on:
            self._cohort_on = self.program.cohort_fallback_key() is None
        if self._rank_split:
            self._rank_split = self.program.cohort_fallback_key(
                flat=True) is None
        start, restored = self.restore_checkpoint()
        if restored is not None:
            self._wire_ef = {}  # as a fresh process's resume
        self.announce.warning(
            "preemption at round %d (scheduled @%d): mesh shrunk %d -> %d "
            "entries; resuming from %s", round_idx, at, old, ndev,
            (f"checkpoint round {start}" if restored is not None else
             "live state (no checkpoint configured)"))
        obs_actions.record_action(
            "shrink_mesh", rule="device-loss", round_idx=round_idx,
            detail={"devices_before": int(old), "devices_after": int(ndev),
                    "scheduled_round": int(at),
                    "resume_round": (int(start) if restored is not None
                                     else int(round_idx))})
        return (start, restored) if restored is not None \
            else (round_idx, None)

    def read_round(self, round_idx: int, loss: torch.Tensor,
                   n_bad: torch.Tensor | None = None) -> float:
        """The round's loss on the host (one device read); non-finite
        uploads go into ``stat_info`` with a warning, and the privacy
        ledger is charged through the round."""
        self.record_privacy(round_idx)
        if n_bad is None:
            return self.read_host([loss])[0]
        loss_h, bad_h = self.read_host([loss, n_bad])
        if bad_h:
            self.stat_info["nonfinite_uploads"] += bad_h
            self.announce.warning(
                "round %d: %d non-finite uploads %s", round_idx, int(bad_h),
                "dropped" if self.sq_spec is None else
                "folded as the zero residue")
        return loss_h

    def masks_nnz(self, masks: list[State]) -> torch.Tensor:
        """Each real client's count of kept entries over the maskable
        leaves, on the device."""
        return torch.stack([mask_nnz(m) for m in masks[:self.real_clients]])

    def warn_if_masks_collapsed(self, masks: list[State], round_idx: int
                                ) -> np.ndarray:
        """Each real client's count of kept entries over the maskable
        leaves (one device read), through :meth:`warn_collapsed`."""
        nnz = self.warn_collapsed(self.masks_nnz(masks).cpu().numpy(),
                                  round_idx)
        per_client = sum(v.numel() for v in masks[0].values())
        if per_client > 0 and nnz.size:
            obs_health.publish_mask_density(
                self.name, round_idx, float(np.mean(nnz) / per_client))
        return nnz

    def warn_collapsed(self, nnz, round_idx: int) -> np.ndarray:
        """Logs a warning naming every client whose mask kept none of the
        host counts ``nnz`` (a NaN in the weights or gradients ranks every
        entry out)."""
        nnz = np.asarray(nnz)
        if (nnz == 0).any():
            self.announce.warning(
                "round %d: clients %s evolved an EMPTY mask (0 surviving "
                "weights) — a NaN in params/gradients poisons the "
                "fire/regrow magnitude ranks into all-False; check the "
                "local losses of these clients for divergence",
                round_idx, np.flatnonzero(nnz == 0).tolist())
        return nnz

    def metrics(self, round_idx: int, **values) -> None:
        """One metrics record in the experiment log, where there is one,
        and in the metrics registry."""
        if self.log is not None:
            self.log.metrics(round_idx, **values)
        else:
            publish_registry(round_idx, {
                k: v for k, v in values.items()
                if isinstance(v, (int, float, dict))})

    def is_eval_round(self, round_idx: int) -> bool:
        f = self.cfg.fed
        return (round_idx % f.frequency_of_the_test == 0
                or round_idx == f.comm_round - 1)

    # ---------- aggregation ----------

    def aggregate(self, states: list[State], w: torch.Tensor) -> State:
        """The weighted mean over clients (weights normalized first, then
        ``sum_s x_s * w_s`` per leaf): FedAvg. On a two-level mesh the mean
        is taken silo first (``parallel/hierarchical.py``), or flat, with
        the reference's line once, where the clients do not tile the
        mesh."""
        from neuroimagedisttraining_tpu_torch.parallel.hierarchical import (
            is_two_level, silo_then_global_mean,
        )

        if not states or not states[0]:
            return robust.weighted_mean(states, w)
        if is_two_level(self.mesh):
            if len(states) % self.mesh.devices.size == 0:
                return silo_then_global_mean(states, w, self.mesh)
            if not getattr(self, "_warned_flat_fallback", False):
                self._warned_flat_fallback = True
                self.announce.info(
                    "two-level mesh: sampled-client axis (%d) does not "
                    "tile the %d-device grid; falling back to the FLAT "
                    "weighted mean (same result, but aggregation will NOT "
                    "be routed silo-first over ICI/DCN). Choose frac so "
                    "client_num_per_round is a multiple of the device "
                    "count to keep the two-level routing.",
                    len(states), self.mesh.devices.size)
        return robust.weighted_mean(states, w)

    def gossip_mixer(self, M: np.ndarray):
        """The consensus ``x -> einsum("cj,j...->c...", M, x)`` of a stacked
        client leaf: ring shifts or the routed exchange over the mesh
        where ``M``'s pattern allows (``parallel/gossip.py`` ``make_plan``),
        else the dense einsum (over the real clients' block where the
        padding clients weigh nothing in it)."""
        from neuroimagedisttraining_tpu_torch.parallel import gossip

        plan, arrays = (gossip.make_plan(M, self.mesh, self.num_clients)
                        if self.mesh is not None else (None, {}))
        if isinstance(plan, gossip.SparseSpec):
            return lambda x: gossip.gossip_apply_sparse(
                {"x": x}, plan, arrays, self.mesh)["x"]
        if plan is not None:
            return lambda x: gossip.gossip_apply({"x": x}, plan,
                                                 self.mesh)["x"]
        R = self.real_clients
        if 0 < R < M.shape[0] and not M[:R, R:].any():
            # the padding clients (rows R on) give no real client weight:
            # the real clients mix over the real block alone, so their sums
            # are the unpadded run's, bit for bit
            Mr, Mp = self.to_device(M[:R, :R]), self.to_device(M[R:])
            return lambda x: torch.cat([
                torch.einsum("cj,j...->c...", Mr, x[:R]),
                torch.einsum("cj,j...->c...", Mp, x)])
        Mt = self.to_device(M)
        return lambda x: torch.einsum("cj,j...->c...", Mt, x)

    def guard_uploads(self, params_up: list[State], bstats_up: list[State],
                      ref_params: State, ref_bstats: State, ns: torch.Tensor,
                      losses: torch.Tensor):
        """A client whose upload holds a NaN/Inf is swapped for the
        broadcast reference and weighs 0 (without a defense, one bad client
        would poison the mean). Returns ``(params_up, bstats_up, w,
        mean_loss, n_bad)``: the guarded uploads, the weights ``ns`` with
        the bad clients' zeroed, the weighted mean of the finite losses and
        the count of bad clients, all on the device."""
        finite = robust.finite_per_client(
            [{**p, **b} for p, b in zip(params_up, bstats_up)])
        w = ns.to(torch.float32) * finite.to(torch.float32)
        safe = torch.where(torch.isfinite(losses), losses,
                           torch.zeros_like(losses))
        mean_loss = torch.sum(safe * w) / torch.clamp(torch.sum(w), min=1e-9)
        return (robust.replace_nonfinite_clients(params_up, ref_params,
                                                 finite),
                robust.replace_nonfinite_clients(bstats_up, ref_bstats,
                                                 finite),
                w, mean_loss, torch.sum(~finite))

    @staticmethod
    def scatter_sampled_rows(all_states: list, new_states: list,
                             sampled_idx, real) -> list:
        """Write the sampled clients' new states into the per-client list;
        entries whose ``real`` flag is False are dropped."""
        out = list(all_states)
        for c, st, r in zip(sampled_idx, new_states, real):
            if r:
                out[int(c)] = st
        return out

    # ---------- the defended tail ----------

    def noise_for(self, stream: str, round_idx: int, client: int,
                  like: State) -> State:
        """Standard normal draws shaped like each leaf of ``like``, for the
        noise ``stream`` (``NOISE_STREAMS``) of client ``client`` in round
        ``round_idx``: each leaf from a generator on ``like``'s device
        keyed by (seed, stream, round, rank, leaf) (``core/robust.py``
        ``noise_draws``)."""
        return robust.noise_draws(self.cfg.seed, stream, round_idx, client,
                                  like)

    def byz_round_plan(self, round_idx: int, sampled):
        """The round's attack plan over the sampled clients (client ``c`` is
        rank ``c + 1``): ``(mult, std, nonfinite)`` numpy arrays, or None
        when the schedule has no value faults."""
        sched = self.fault_schedule
        if sched is None or not sched.spec.any_value_faults:
            return None
        ranks = np.asarray(sampled) + 1
        mult, std, nan = adversary.plan_arrays(sched, round_idx, ranks)
        bad = np.flatnonzero((mult != 1.0) | (std != 0.0) | nan)
        if bad.size:
            self.announce.info(
                "round %d: clients %s upload BYZANTINE values (%s)",
                round_idx, np.asarray(sampled)[bad].tolist(),
                [sched.byzantine_kind(round_idx, int(r))
                 for r in ranks[bad]])
        return mult, std, nan

    def wire_masks(self, ref: State) -> State | None:
        """The mask the codec packs uploads against (keyed like an upload),
        or None for the top-k stage. Base engines own no mask."""
        return None

    def codec_stage(self, sampled, uploads: list[State], ref: State,
                    masks: State | None) -> list[State]:
        """The wire codec's lossy roundtrip of each upload, against the
        round's broadcast ``ref``: with per-client error feedback where the
        engine keeps it (a non-finite upload's next feedback is zero, so
        the fault stays transient), else against ``masks``. Adds the
        round's encoded and dense bytes to ``stat_info``."""
        spec = self.wire_spec
        if self.wire_uses_ef and spec.needs_ef:
            efs = [self._wire_ef.get(int(c)) for c in sampled]
            efs = [e if e is not None else
                   {k: torch.zeros_like(v, dtype=torch.float32)
                    for k, v in ref.items()} for e in efs]
            outs = [codec_device.lossy_roundtrip(spec, u, reference=ref,
                                                 ef=e)
                    for u, e in zip(uploads, efs)]
            fin = robust.finite_per_client(uploads)
            for j, c in enumerate(sampled):
                if self.n_train[c] > 0:
                    self._wire_ef[int(c)] = {
                        k: torch.where(fin[j], e, torch.zeros_like(e))
                        for k, e in outs[j][1].items()}
        else:
            outs = [codec_device.lossy_roundtrip(spec, u, reference=ref,
                                                 masks=masks)
                    for u in uploads]
        decoded = [d for d, _ in outs]
        self.account_wire_bytes(decoded[0], ref, masks, len(sampled))
        return decoded

    def account_wire_bytes(self, upload: State, ref: State,
                           masks: State | None = None,
                           n_uploads: int = 1) -> int:
        """Add ``n_uploads`` times the encoded frame size of ``upload`` (one
        representative upload: uploads share sizes up to zlib's) to
        ``sum_comm_bytes``, and the dense msgpack size the plain wire would
        ship to ``sum_comm_bytes_dense``; the frames in the reference's
        names and layout, so the bytes are the reference's. One device
        read of the upload. Returns the frame size."""
        pkeys = {k for k, _ in self.trainer.model.named_parameters()}

        def named(st):
            return flax_named_leaves(
                {k: v for k, v in st.items() if k in pkeys},
                {k: v for k, v in st.items() if k not in pkeys})

        up, refh = named(upload), named(ref)
        frame, _ = codec_wire.encode_update(
            self.wire_spec, up, reference=refh,
            masks=named(masks) if masks is not None else None,
            mask_on_wire=False)
        nbytes = codec_wire.frame_nbytes(frame)
        if self._dense_upload_nbytes is None:
            self._dense_upload_nbytes = codec_wire.frame_nbytes(
                codec_wire.nest(up))
        self.stat_info["sum_comm_bytes"] += float(nbytes * n_uploads)
        self.stat_info["sum_comm_bytes_dense"] += float(
            self._dense_upload_nbytes * n_uploads)
        return nbytes

    def defended_aggregate(self, round_idx: int, sampled,
                           params_up: list[State], bstats_up: list[State],
                           ref_params: State, ref_bstats: State,
                           ns: torch.Tensor, losses: torch.Tensor):
        """The round's tail over the sampled clients' uploads: the attack
        (``byz:`` faults), the codec (``--wire_codec``), the non-finite
        guard (:meth:`guard_uploads`), the defense and the aggregation;
        under ``--secure_quant`` the attack, then the GF(p) fold
        (:meth:`secure_quant_aggregate`). Returns ``(params, bstats,
        mean_loss, n_bad)``, all on the device. With none armed it is the
        guarded FedAvg."""
        f = self.cfg.fed
        plan = self.byz_round_plan(round_idx, sampled)
        if plan is not None or self.wire_spec is not None:
            # the attack and the codec take the whole upload, parameters
            # and BatchNorm statistics (what the wire ships)
            ref = {**ref_params, **ref_bstats}
            uploads = [{**p, **b} for p, b in zip(params_up, bstats_up)]
            if plan is not None:
                mult, std, nan = plan
                noises = [self.noise_for("attack", round_idx, int(c), ref)
                          if std[j] != 0 else None
                          for j, c in enumerate(sampled)]
                uploads = adversary.apply_attack_stacked(uploads, ref, mult,
                                                         std, nan, noises)
            if self.wire_spec is not None:
                uploads = self.codec_stage(sampled, uploads, ref,
                                           self.wire_masks(ref))
            params_up = [{k: u[k] for k in ref_params} for u in uploads]
            bstats_up = [{k: u[k] for k in ref_bstats} for u in uploads]
        if self.sq_spec is not None:
            out = self.secure_quant_aggregate(round_idx, sampled, params_up,
                                              bstats_up, ref_params, ns,
                                              losses)
            self._note_update_health(params_up, ref_params, out[0], ns)
            return out
        measured = params_up
        params_up, bstats_up, w, mean_loss, n_bad = self.guard_uploads(
            params_up, bstats_up, ref_params, ref_bstats, ns, losses)
        defense = robust.effective_defense(self.active_defense(),
                                           len(params_up), f.byz_f,
                                           warn=self._warn_once)
        if defense in robust.ROBUST_AGGREGATORS:
            agg = robust.robust_aggregate(
                [{**p, **b} for p, b in zip(params_up, bstats_up)], w,
                defense=defense, byz_f=f.byz_f, geomed_iters=f.geomed_iters)
            new_p = {k: agg[k] for k in ref_params}
            self._note_update_health(measured, ref_params, new_p, ns)
            return new_p, {k: agg[k] for k in ref_bstats}, mean_loss, n_bad
        noises = ([self.noise_for("weak_dp", round_idx, int(c), ref_params)
                   for c in sampled] if defense == "weak_dp" else None)
        params_up = robust.defend_stacked(
            params_up, ref_params, defense=defense, norm_bound=f.norm_bound,
            stddev=f.stddev, noises=noises)
        new_p = self.aggregate(params_up, w)
        self._note_update_health(measured, ref_params, new_p, ns)
        return new_p, self.aggregate(bstats_up, w), mean_loss, n_bad

    def _note_update_health(self, uploads: list[State], ref: State,
                            new_params: State, w: torch.Tensor) -> None:
        """The round's update stats (``program.health_update_stats``) on
        the uploads the tail took, queued under ``--health_stats``."""
        if self.health_on:
            self.note_health(round_program.health_update_stats(
                uploads, ref, new_params, w))

    def secure_quant_aggregate(self, round_idx: int, sampled,
                               params_up: list[State],
                               bstats_up: list[State], ref_params: State,
                               ns: torch.Tensor, losses: torch.Tensor):
        """``--secure_quant``'s tail: the clip family on each client's
        parameters (before quantization, as a client would), then the
        whole upload, parameters and BatchNorm statistics, through the
        GF(p) fold at integer weights (``mpc_device.secure_quant_fold``).
        No guard: a non-finite row quantizes to the zero residue and its
        weight stays in the mass; ``n_bad`` counts such rows and gates
        nothing. The mean loss weighs the finite losses by sample count.
        Returns ``(params, bstats, mean_loss, n_bad)`` on the device, with
        no host sync."""
        f = self.cfg.fed
        if f.defense_type != "none":
            noises = ([self.noise_for("weak_dp", round_idx, int(c),
                                      ref_params) for c in sampled]
                      if f.defense_type == "weak_dp" else None)
            params_up = robust.defend_stacked(
                params_up, ref_params, defense=f.defense_type,
                norm_bound=f.norm_bound, stddev=f.stddev, noises=noises)
        uploads = [{**p, **b} for p, b in zip(params_up, bstats_up)]
        n_bad = torch.sum(~robust.finite_per_client(uploads))
        w = ns.to(torch.float32)
        safe = torch.where(torch.isfinite(losses), losses,
                           torch.zeros_like(losses))
        mean_loss = torch.sum(safe * w) / torch.clamp(torch.sum(w), min=1e-9)
        spec = self.sq_spec
        agg = mpc_device.secure_quant_fold(uploads, w, spec.p, spec.frac_bits,
                                           self.sq_weight_shift,
                                           self.sq_scales)
        return ({k: agg[k] for k in params_up[0]},
                {k: agg[k] for k in bstats_up[0]}, mean_loss, n_bad)

    def _warn_once(self, fmt: str, *args) -> None:
        """A warning logged once a run (``effective_defense``'s, once a
        cohort size, as the reference's at its trace)."""
        msg = fmt % args
        seen = self.__dict__.setdefault("_warned", set())
        if msg not in seen:
            seen.add(msg)
            self.announce.warning(msg)

    # ---------- privacy accounting ----------

    def record_privacy(self, round_idx: int) -> None:
        """Charge the RDP ledger for every round through ``round_idx`` and
        publish the running (epsilon, delta) in ``stat_info``, one entry a
        round (host numpy, no device read). The armed source: the
        ``weak_dp`` defense (a subsampled Gaussian at q = cohort / clients
        with the effective multiplier over the round's sample-count
        weights, the cohorts re-derived from the sampling) or ``dp_sigma >
        0`` (D-PSGD: full participation, q = 1, multiplier ``dp_sigma``)."""
        from neuroimagedisttraining_tpu_torch.privacy import accountant as acct

        f = self.cfg.fed
        weak = f.defense_type == "weak_dp"
        dp = f.dp_sigma > 0
        if not (weak or dp) or round_idx <= self._dp_recorded_through:
            return
        if weak and (f.stddev <= 0 or f.norm_bound <= 0):
            if not getattr(self, "_warned_dp_disabled", False):
                self._warned_dp_disabled = True
                self.announce.warning(
                    "weak_dp with stddev=%s/norm_bound=%s adds no "
                    "accountable noise — epsilon is infinite; the "
                    "accountant records nothing", f.stddev, f.norm_bound)
            return
        key = "weak_dp" if weak else "dp"
        stats = self.stat_info.setdefault(key, {
            "norm_bound": f.norm_bound if weak else f.dp_clip,
            "stddev": f.stddev if weak else f.dp_sigma * f.dp_clip,
            "delta": f.dp_delta, "noise_multiplier_per_round": [],
            "epsilon_per_round": [], "epsilon": 0.0})
        if self._dp_rdp is None:
            self._dp_rdp = np.zeros(len(acct.DEFAULT_ORDERS), np.float64)
        for r in range(self._dp_recorded_through + 1, round_idx + 1):
            if weak:
                sampled = self.client_sampling(r)
                w = self.n_train[np.asarray(sampled)]
                q = len(sampled) / max(1, self.real_clients)
                z = acct.weak_dp_noise_multiplier(f.stddev, f.norm_bound, w)
            else:
                q, z = 1.0, f.dp_sigma
            self._dp_rdp = self._dp_rdp + acct.rdp_gaussian(q, z)
            eps = acct.rdp_to_epsilon(self._dp_rdp, delta=f.dp_delta)[0]
            stats["noise_multiplier_per_round"].append(round(z, 6))
            stats["epsilon_per_round"].append(round(eps, 4))
        stats["epsilon"] = stats["epsilon_per_round"][-1]
        # under the sampling model every silo's loss is the same
        stats["epsilon_per_silo"] = {
            int(c): stats["epsilon"] for c in range(self.real_clients)}
        self._dp_recorded_through = round_idx


    # ---------- evaluation ----------

    def eval_ids(self) -> tuple[int, ...]:
        """The clients an evaluation takes: every client, or client 0 alone
        under ``fed.ci`` (the reference's CI mode)."""
        return (0,) if self.cfg.fed.ci else tuple(range(self.num_clients))

    def _eval_clients(self, states: list[tuple[State, State]]
                      ) -> dict[str, float]:
        """Each evaluated client's state (:meth:`eval_ids`) on its own test
        rows, summarized (the reference package's ``eval_global_stream``
        and ``eval_personalized_stream`` too: the walk serves both
        paths)."""
        with obs_trace.span("eval", engine=self.name):
            return self._eval_rows(states)

    def _eval_rows(self, states: list[tuple[State, State]]
                   ) -> dict[str, float]:
        out, n = [], []
        for c, rows in self.client_rows(self.eval_ids(), "test"):
            params, bstats = states[c]
            valid = torch.arange(rows.X.shape[0],
                                 device=self.device) < rows.n
            m = self.trainer.evaluate(params, bstats, rows.X, rows.y, valid)
            auc = binary_auc(m["scores"], rows.y, valid)
            out.append(torch.stack([m["test_correct"], m["test_loss"],
                                    m["test_total"], auc]))
            n.append(rows.n)
        host = torch.stack(out).cpu().numpy()   # one device read
        return self._summarize(*host.T, n=np.asarray(n))

    @staticmethod
    def _summarize(correct, loss, total, auc, n) -> dict[str, float]:
        """Mean over clients with data of the per-client ratios, plus the
        pooled accuracy."""
        correct, loss, total, auc, n = map(np.asarray,
                                           (correct, loss, total, auc, n))
        mask = n > 0
        if not np.any(mask):
            return {"acc": 0.0, "loss": 0.0, "auc": 0.0, "acc_pooled": 0.0}
        accs = correct[mask] / np.maximum(total[mask], 1)
        losses = loss[mask] / np.maximum(total[mask], 1)
        return {
            "acc": float(np.mean(accs)),
            "loss": float(np.mean(losses)),
            "auc": float(np.mean(auc[mask])),
            "acc_pooled": float(correct[mask].sum()
                                / max(total[mask].sum(), 1)),
        }

    def eval_global(self, params: State, bstats: State) -> dict[str, float]:
        return self._eval_clients([(params, bstats)] * self.num_clients)

    def eval_personalized(self, per_params: list[State],
                          per_bstats: list[State]) -> dict[str, float]:
        return self._eval_clients(list(zip(per_params, per_bstats)))
