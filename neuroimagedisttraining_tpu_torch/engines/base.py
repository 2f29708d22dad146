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
(``parallel/gossip.py``). A streamed round pads nothing (sharding refuses
streaming, as the reference's ``streaming-sharded-feed``).

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
from neuroimagedisttraining_tpu_torch.ops import mpc_device
from neuroimagedisttraining_tpu_torch.ops.masks import mask_nnz
from neuroimagedisttraining_tpu_torch.parallel import cohort
from neuroimagedisttraining_tpu_torch.utils.logging import ExperimentLogger
from neuroimagedisttraining_tpu_torch.weights import flax_named_leaves

State = dict[str, torch.Tensor]

log = logging.getLogger(__name__)

#: the noise streams of ``noise_for``
NOISE_STREAMS = {"attack": 1, "weak_dp": 2, "dp": 3}


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
        }
        self._init_defended_round(stream)
        self._init_dispatch()

    def _init_dispatch(self) -> None:
        """The startup checks of ``--client_mesh`` and
        ``--rounds_per_dispatch``, with the reference's messages: a mesh of
        another size is an error; an engine or mode that cannot shard or
        run windows says so once, with its reason."""
        f = self.cfg.fed
        self._cohort_on = False
        cm = int(f.client_mesh)
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
                log.info(
                    "client_mesh=%d: cohort sharding armed — the sampled-"
                    "client axis of every round shards over the "
                    "%d-device mesh (pad rows zero-weighted; "
                    "parallel/cohort.py)", cm, mesh.devices.size)
            else:
                round_program.report_fallback(
                    self.name, key, "client_mesh=%d requested; running the "
                    "unsharded round program", cm)
        if f.rounds_per_dispatch > 1:
            key = self.fused_fallback_key()
            if key is not None:
                round_program.report_fallback(
                    self.name, key, "rounds_per_dispatch=%d requested; "
                    "dispatching one round at a time",
                    f.rounds_per_dispatch)

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

    def _ckpt_active(self) -> bool:
        """Checkpoints are not ported: no round is a checkpoint round."""
        return False

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
        trains nothing and is dropped, so the list is ``ids``'."""
        ids = np.asarray(ids)
        if not self._cohort_on:
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
            self.mesh, lambda it: None if it[1] is None else fn(*it), items,
            self.device)
        return out[:n_real]

    # ---------- the round loop with windows ----------

    def window_round(self, carry: tuple, round_idx: int, sampled):
        """One round of the engine's declared round from ``carry``:
        ``(carry, outs)``, ``outs`` a dict of device scalars (``loss``,
        and ``n_bad`` where the round counts non-finite uploads). Engines
        that declare ``round_stages`` implement it."""
        raise NotImplementedError

    def run_rounds(self, carry: tuple, on_round) -> tuple:
        """Every round from ``carry``: one at a time, or in windows under
        ``--rounds_per_dispatch``. After each round's outputs are read,
        ``on_round(r, carry, row, seconds, sampled)`` runs in round order
        (``row``: the round's outputs as host floats; ``carry``: the state
        after the window, which is the round's own for the window's last
        round, the only one that can be hooked; ``seconds``: the window's
        time shared by its rounds). Returns the last carry."""
        f = self.cfg.fed
        fuse = self._fuse()
        r = 0
        while r < f.comm_round:
            k = self.program.dispatch_window(r) if fuse else 1
            t0 = time.perf_counter()
            if k > 1:
                carry, outs, wi = self.program.run_window(carry, r, k)
                k, sampled = wi.k, wi.sampled
            else:
                self.plan_walks(r)
                s = self.round_sampling(r)
                carry, o = self.window_round(carry, r, s)
                outs, sampled = [o], [s]
            rows = self.read_outs(r, outs)
            self._sync()
            dt = (time.perf_counter() - t0) / k
            for off, row in enumerate(rows):
                on_round(r + off, carry, row, dt,
                         sampled[off] if sampled is not None else None)
            r += k
        return carry

    def round_sampling(self, round_idx: int):
        """A single round's cohort, logged (None for an engine that trains
        every client)."""
        sampled = self.client_sampling(round_idx)
        log.info("round %d: clients %s", round_idx, sampled.tolist())
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
        and the privacy ledger is charged through the last round."""
        names = [list(o) for o in outs]
        flat = self.read_host([v for o in outs for v in o.values()])
        rows, i = [], 0
        for r, keys in enumerate(names):
            row = dict(zip(keys, flat[i:i + len(keys)]))
            i += len(keys)
            bad = row.get("n_bad", 0.0)
            if bad:
                self.stat_info["nonfinite_uploads"] += bad
                log.warning("round %d: %d non-finite uploads %s",
                            round_idx + r, int(bad),
                            "dropped" if self.sq_spec is None else
                            "folded as the zero residue")
            rows.append(row)
        self.record_privacy(round_idx + len(outs) - 1)
        return rows

    def _init_defended_round(self, stream) -> None:
        """The fault schedule, the privacy ledger and the wire codec's
        state; what this engine cannot run (a fault, defense, DP or codec
        flag) fails here, at startup, with the reference's messages."""
        f = self.cfg.fed
        spec = parse_fault_spec(f.fault_spec) if f.fault_spec else None
        if spec is not None and spec.preempts:
            raise ValueError(
                "--fault_spec preempt: directives need the elastic device "
                "plane (a training mesh that shrinks and resumes from a "
                "checkpoint), which the port does not have")
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
            np.random.seed(round_idx)
            sampled = np.sort(np.random.choice(range(total), per_round,
                                               replace=False))
        if self.fault_schedule is not None:
            # crashed clients (rank = index + 1) leave the cohort; the
            # weighted mean over the survivors re-weights by sample count
            sampled = self.fault_schedule.survivors(round_idx, sampled)
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
        """Clients a streamed chunk holds: ``stream_chunk_clients``, or 4."""
        return self.cfg.stream_chunk_clients or 4

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

    def stream_window(self, sampled: list, next_round: int) -> list[dict]:
        """A streamed window's training rows, one fetch for its rounds
        (``get_window``), each round's as a dict client -> rows; the next
        window's fetch starts behind it unless the window ends at an
        evaluation, whose test walks come first."""
        X, y, _ = self.stream.get_window(sampled)
        out = [{int(c): ClientRows(X[off, j], y[off, j],
                                   int(self.n_train[c]))
                for j, c in enumerate(ids)}
               for off, ids in enumerate(sampled)]
        last = next_round - 1
        if next_round < self.cfg.fed.comm_round \
                and not self.is_eval_round(last):
            k = self.program.dispatch_window(next_round)
            if k > 1:
                nxt, _ = self.program.window_sampling(next_round, k)
                self.stream.prefetch_window(nxt)
        return out

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
            log.warning("round %d: %d non-finite uploads %s", round_idx,
                        int(bad_h), "dropped" if self.sq_spec is None else
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
        return self.warn_collapsed(self.masks_nnz(masks).cpu().numpy(),
                                   round_idx)

    @staticmethod
    def warn_collapsed(nnz, round_idx: int) -> np.ndarray:
        """Logs a warning naming every client whose mask kept none of the
        host counts ``nnz`` (a NaN in the weights or gradients ranks every
        entry out)."""
        nnz = np.asarray(nnz)
        if (nnz == 0).any():
            log.warning("round %d: clients %s have an empty mask (0 kept "
                        "weights); check their local losses for divergence",
                        round_idx, np.flatnonzero(nnz == 0).tolist())
        return nnz

    def metrics(self, round_idx: int, **values) -> None:
        """One metrics record in the experiment log, where there is one."""
        if self.log is not None:
            self.log.metrics(round_idx, **values)

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
                log.info(
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
        else the dense einsum."""
        from neuroimagedisttraining_tpu_torch.parallel import gossip

        plan, arrays = (gossip.make_plan(M, self.mesh, self.num_clients)
                        if self.mesh is not None else (None, {}))
        if isinstance(plan, gossip.SparseSpec):
            return lambda x: gossip.gossip_apply_sparse(
                {"x": x}, plan, arrays, self.mesh)["x"]
        if plan is not None:
            return lambda x: gossip.gossip_apply({"x": x}, plan,
                                                 self.mesh)["x"]
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
        keyed by (seed, stream, round, rank, leaf)."""
        out = {}
        for i, (k, v) in enumerate(like.items()):
            key = np.random.SeedSequence(
                [self.cfg.seed, NOISE_STREAMS[stream], round_idx + 1,
                 client + 1, i]).generate_state(2, np.uint32)
            gen = torch.Generator(device=v.device).manual_seed(
                (int(key[0]) | int(key[1]) << 32) & (2 ** 63 - 1))
            out[k] = torch.randn(v.shape, generator=gen, device=v.device,
                                 dtype=torch.float32)
        return out

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
            log.info("round %d: clients %s upload BYZANTINE values (%s)",
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
            return self.secure_quant_aggregate(round_idx, sampled, params_up,
                                               bstats_up, ref_params, ns,
                                               losses)
        params_up, bstats_up, w, mean_loss, n_bad = self.guard_uploads(
            params_up, bstats_up, ref_params, ref_bstats, ns, losses)
        defense = robust.effective_defense(f.defense_type, len(params_up),
                                           f.byz_f, warn=self._warn_once)
        if defense in robust.ROBUST_AGGREGATORS:
            agg = robust.robust_aggregate(
                [{**p, **b} for p, b in zip(params_up, bstats_up)], w,
                defense=defense, byz_f=f.byz_f, geomed_iters=f.geomed_iters)
            return ({k: agg[k] for k in ref_params},
                    {k: agg[k] for k in ref_bstats}, mean_loss, n_bad)
        noises = ([self.noise_for("weak_dp", round_idx, int(c), ref_params)
                   for c in sampled] if defense == "weak_dp" else None)
        params_up = robust.defend_stacked(
            params_up, ref_params, defense=defense, norm_bound=f.norm_bound,
            stddev=f.stddev, noises=noises)
        return (self.aggregate(params_up, w), self.aggregate(bstats_up, w),
                mean_loss, n_bad)

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
            log.warning(msg)

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
                log.warning(
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
