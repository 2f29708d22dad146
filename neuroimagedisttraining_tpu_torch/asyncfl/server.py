"""``BufferedFedAvgServer``: FedBuff-style asynchronous aggregation (the
reference package's ``asyncfl/server.py``).

Nguyen et al., "Federated Learning with Buffered Asynchronous Aggregation"
(AISTATS 2022): the server never waits for a cohort. It accepts uploads
continuously into a bounded buffer and aggregates every K arrivals,
down-weighting stale contributions.

- **Versions** ride the round tag: the model version (the number of
  aggregations so far) goes out as ``ARG_ROUND_IDX`` on every sync and a
  silo echoes it on its upload; an upload's staleness is ``tau = version
  - echoed``.
- **Codec references**: a ring of the last ``max_staleness + 1`` broadcast
  trees; a delta frame decodes against the very tree broadcast under its
  tag (decoded against the current model it would be another update).
- **Aggregation** through the synchronous server's own functions,
  ``survivor_weighted_mean`` undefended and ``survivor_defended_mean``
  under a ``--defense``, on the server's device, over the "effective
  uploads" ``u + (params_now - params_base)``: the stale upload's learning
  carried to the current base, in float32 numpy on the host. An upload of
  staleness 0 reaches the mean untouched, so a buffer of all-current
  uploads with ``buffer_k == cohort`` is one synchronous round bit for
  bit.
- **Weights**: ``staleness_weight(n, tau, alpha) = n * (1 + tau)^-alpha``,
  exactly ``n`` at ``tau == 0``; an upload staler than ``max_staleness``
  is dropped at admission.
- **Quarantine, strikes, heartbeats, the EF reset** are the synchronous
  server's: outlier scoring runs at each aggregation over the buffer's
  carried trees against the current model.
- **Secure quantized aggregation** (``secure_quant``): the one-phase
  protocol, each silo shipping a field-element frame of its unweighted
  update and ``n`` in the clear; the staleness weights fold inside the
  field as integers (``privacy/secure_quant.integer_weights``). Dense
  two-phase ``--secure`` is a round barrier and is refused by the CLI.

Protocol, with no barrier anywhere: a register is answered at once with
the current model (``INIT_CONFIG`` the first time, ``SYNC_MODEL`` after);
an upload is accepted or dropped, may trigger an aggregation, and its
sender gets the current model at once; after ``comm_round`` aggregations
every rank that registered gets FINISH.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from neuroimagedisttraining_tpu_torch.asyncfl.loop import SelectorCommManager
from neuroimagedisttraining_tpu_torch.distributed import message as M
from neuroimagedisttraining_tpu_torch.distributed.comm import BASE_PORT
from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (
    FedAvgServer, _named_tensors, silo_noise,
    survivor_defended_mean, survivor_weighted_mean, tree_all_finite,
    tree_map,
)
from neuroimagedisttraining_tpu_torch.obs import flight as obs_flight
from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
from neuroimagedisttraining_tpu_torch.obs import names as obs_names
from neuroimagedisttraining_tpu_torch.obs import rules as obs_rules
from neuroimagedisttraining_tpu_torch.obs import trace as obs_trace

log = logging.getLogger("neuroimagedisttraining_tpu_torch.asyncfl")

#: flow-end events an aggregation emits when the tracer is armed (bounded:
#: the trace does not grow with buffer_k)
_FLOW_ENDS_MAX = 64


def staleness_weight(n: float, tau: int, alpha: float) -> float:
    """FedBuff's polynomial staleness weight on the sample count, ``n *
    (1 + tau)^-alpha``, in float64 on the host: exactly ``n`` at ``tau ==
    0``."""
    return float(n) * (1.0 + float(int(tau))) ** (-float(alpha))


def carry_to_base(u, params, base):
    """A stale upload ``u`` (trained from ``base``) carried to the current
    model: ``u + (params - base)`` in float32, leaf by leaf, cast back to
    ``u``'s dtype."""
    return tree_map(
        lambda a, p, r: (np.asarray(a, np.float32)
                         + (np.asarray(p, np.float32)
                            - np.asarray(r, np.float32))
                         ).astype(np.asarray(a).dtype),
        u, params, base)


class BufferedFedAvgServer(FedAvgServer):
    """Rank 0 of the asynchronous control plane (the module docstring has
    the protocol). Knobs:

    - ``buffer_k``: aggregate every K accepted uploads (0 = the cohort,
      which with zero staleness is the synchronous server). A sender holds
      one buffer slot, so the threshold shrinks below K while silos are
      known to be gone (``_k_eff``).
    - ``staleness_alpha``: the polynomial exponent (0 turns the
      down-weighting off).
    - ``max_staleness``: an upload based on a version more than this many
      aggregations old is dropped with a logged reason (its sender synced
      at once); the ring holds this many past versions.
    - ``device``: where the aggregation runs (``cuda`` unless the caller
      asks for the CPU)."""

    def __init__(self, init_params, comm_round: int, num_clients: int,
                 buffer_k: int = 0, staleness_alpha: float = 0.5,
                 max_staleness: int = 20, world_size: int | None = None,
                 host_map: dict[int, str] | None = None,
                 base_port: int | None = None, comm=None,
                 secure_quant=None, **kw):
        from neuroimagedisttraining_tpu_torch.core import robust

        # the knobs fail here, at startup, never mid-run
        self.buffer_k = int(buffer_k) if buffer_k else int(num_clients)
        if self.buffer_k < 1:
            raise ValueError(f"buffer_k must be >= 1, got {buffer_k}")
        if staleness_alpha < 0:
            raise ValueError(
                f"staleness_alpha must be >= 0, got {staleness_alpha}")
        if max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {max_staleness}")
        self.staleness_alpha = float(staleness_alpha)
        self.max_staleness = int(max_staleness)
        if kw.get("round_deadline", 0) or kw.get("quorum", 0):
            raise ValueError(
                "BufferedFedAvgServer has no round barrier: "
                "round_deadline/quorum do not apply (uploads aggregate "
                "every buffer_k arrivals instead)")
        # the one-phase secure-quant fold: no codec transport (frames are
        # not deltas), no non-finite gate, no server-side defense or
        # outlier scoring (the server never sees plaintext); frames fold
        # unscaled, so raw-moment leaves lean on the 32-bit field's margin
        self.secure_quant = secure_quant
        if secure_quant is not None:
            from neuroimagedisttraining_tpu_torch.privacy import (
                check_headroom,
            )
            from neuroimagedisttraining_tpu_torch.privacy import (
                secure_quant as sq,
            )

            if kw.get("defense", "none") in robust.ROBUST_AGGREGATORS \
                    or kw.get("quarantine_rounds", 0):
                raise ValueError(
                    "secure_quant supports neither order-statistic "
                    "defenses nor quarantine on the buffered server: "
                    "the buffer holds masked field elements, not "
                    "per-silo updates (clip-family defenses run client-"
                    "side; see ARCHITECTURE.md 'Privacy plane')")
            if kw.get("wire_masks") is not None:
                raise ValueError(
                    "secure_quant is incompatible with the wire codec "
                    "mask handoff (field-element frames, not model "
                    "floats)")
            check_headroom(secure_quant, min(self.buffer_k,
                                             int(num_clients)))
            # the fold applies the integer staleness weights inside the
            # field: the bound starts from the init model's largest leaf
            # magnitude, doubled for drift
            init_mag = max((float(np.max(np.abs(np.asarray(x, np.float64))))
                            for _, x in sq._named_leaves(init_params)
                            if np.asarray(x).size), default=0.0)
            self._sq_value_bound = max(sq.VALUE_BOUND, 2.0 * init_mag)
            k_cap = min(self.buffer_k, int(num_clients))
            cap = sq.weighted_fold_capacity(secure_quant,
                                            self._sq_value_bound)
            if cap <= k_cap:
                raise ValueError(
                    f"secure_quant field too small for the buffered "
                    f"one-phase fold: capacity {cap:.1f} weight units "
                    f"< buffer of {k_cap} at value bound "
                    f"{self._sq_value_bound:.0f} — use "
                    "--secure_quant_field_bits 32 (the two-phase sync "
                    "protocol keeps the small field; see "
                    "ARCHITECTURE.md 'Privacy plane')")
            #: the frame leaf structure the admission gate holds every
            #: upload to (fixed for the run)
            self._sq_sizes = [(n, int(np.asarray(x).size))
                              for n, x in sq._named_leaves(init_params)]
        if comm is None:
            # replies run on the one dispatch thread: a peer that stops
            # reading stalls it at most 2 s, then its send raises and
            # _send_tolerant marks it suspect
            comm = SelectorCommManager(
                0, world_size or num_clients + 1, host_map=host_map,
                base_port=BASE_PORT if base_port is None else base_port,
                send_timeout=2.0)
        super().__init__(init_params, comm_round, num_clients,
                         world_size=world_size, comm=comm, **kw)
        # one slot a sender caps the cohort of an aggregation at
        # min(buffer_k, num_clients): an order-statistic defense must be
        # feasible over that many
        if self.defense in robust.ROBUST_AGGREGATORS:
            robust._check_f(min(self.buffer_k, int(num_clients)),
                            self.byz_f, self.defense)
        #: no registration barrier: started from the first moment (the
        #: heartbeat monitor then calls _maybe_complete on a new suspect)
        self._started = True
        #: version -> the broadcast tree, the delta reference of frames
        #: tagged with it
        self._ring: dict[int, dict] = {0: self.params}
        #: accepted uploads not yet aggregated, in arrival order
        self._buffer: list[dict] = []
        #: sender -> the highest ARG_UPLOAD_SEQ seen (a re-delivery repeats
        #: its seq and is dropped; reset at a re-register)
        self._seq_seen: dict[int, int] = {}
        #: sender -> base versions accepted, the dedup of senders that ship
        #: no seq (one contribution a sync version)
        self._contributed: dict[int, set[int]] = {}
        #: every _on_model bumps ``received`` and exactly one other counter
        #: (the audit, upload_audit)
        self.upload_stats = {
            "received": 0, "accepted": 0, "dropped_stale": 0,
            "dropped_duplicate": 0, "dropped_future": 0,
            "dropped_quarantined": 0, "dropped_undecodable": 0,
            "dropped_nonfinite": 0, "dropped_after_done": 0,
            # a Message with broken fields (no num_samples, a non-numeric
            # tag)
            "dropped_malformed": 0,
            # accepted, then discarded: this aggregation's scoring
            # quarantined its sender
            "quarantine_discarded": 0,
            # accepted, then discarded with the whole buffer: a secure-
            # quant fold failed (the model kept its version)
            "aggregation_discarded": 0,
            # accepted, then replaced by a newer upload of the same sender
            # before the buffer filled (one slot a sender)
            "superseded_in_buffer": 0,
        }
        # the metrics mirror of upload_stats (every bump through _stat),
        # the staleness the weighting met, the buffer's occupancy
        self._obs_uploads = obs_metrics.counter(
            obs_names.ASYNC_UPLOADS,
            "async-server upload verdicts (mirrors upload_stats)",
            labelnames=("outcome",))
        self._obs_staleness = obs_metrics.histogram(
            obs_names.ASYNC_STALENESS,
            "staleness tau (versions) of accepted uploads",
            buckets=(0, 1, 2, 4, 8, 16, 32, 64))
        self._obs_buffer = obs_metrics.gauge(
            obs_names.ASYNC_BUFFER_OCCUPANCY,
            "uploads currently buffered toward the next aggregation")
        self._obs_k_eff = obs_metrics.gauge(
            obs_names.ASYNC_BUFFER_K_EFF,
            "effective aggregation trigger threshold (buffer_k shrunk "
            "by known-gone clients)")
        self._obs_k_eff.set(self._k_eff())

    def _stat(self, key: str, n: int = 1) -> None:
        """Under ``_rlock``: one ``upload_stats`` counter and its metric,
        bumped together."""
        self.upload_stats[key] += n
        self._obs_uploads.inc(n, outcome=key)

    # one of many silos vanishing mid-reply never stops the dispatch thread
    @property
    def fault_tolerant(self) -> bool:
        return True

    @property
    def version(self) -> int:
        """The model version: the number of aggregations so far
        (``round_idx``)."""
        return self.round_idx

    def current_version(self) -> int:
        with self._rlock:
            return self.round_idx

    def _observe_health_boundary(self) -> None:
        """The armed rules at this version boundary (the sharded root
        evaluates its fan-in's merged snapshot instead)."""
        obs_rules.observe_boundary(self.round_idx)

    # ---- handlers (the dispatch thread) ----

    def _on_register(self, msg: M.Message) -> None:
        """No barrier: first contact gets the current model at once."""
        with self._rlock:
            c = msg.sender_id
            if self._done.is_set():
                self._send_tolerant(M.Message(M.MSG_TYPE_S2C_FINISH, 0, c))
                return
            first = c not in self._registered
            self._registered.add(c)
            self._suspect.discard(c)
            # a restarted process: a fresh seq counter and fresh dedup
            # marks
            self._seq_seen.pop(c, None)
            self._contributed.pop(c, None)
            self._last_beat[c] = time.monotonic()
            if not first:
                log.info("server: client %d re-registered; shipping "
                         "version %d state", c, self.round_idx)
            self._send_sync_to(M.MSG_TYPE_S2C_INIT_CONFIG if first
                               else M.MSG_TYPE_S2C_SYNC_MODEL, c)

    def _on_model(self, msg: M.Message) -> None:
        with self._rlock:
            self._stat("received")
            if self._done.is_set():
                self._stat("dropped_after_done")
                return
            c = msg.sender_id
            self._last_beat[c] = time.monotonic()
            self._suspect.discard(c)
            try:
                ok = self._accept_async(msg)
            except Exception as e:  # noqa: BLE001 — broken fields are a
                # dropped upload, never a dead dispatch thread
                self._stat("dropped_malformed")
                obs_flight.record("drop_malformed", client=c,
                                  version=self.round_idx,
                                  error=f"{type(e).__name__}: {e}")
                log.warning("server: dropping malformed upload from %d "
                            "(%s: %s)", c, type(e).__name__, e)
                ok = False
            if ok:
                self._stat("accepted")
                if len(self._buffer) >= self._k_eff():
                    self._aggregate_buffer()
            if not self._done.is_set():
                # accepted or dropped, the sender trains again at once from
                # the current model
                self._send_sync_to(M.MSG_TYPE_S2C_SYNC_MODEL, c)

    def _accept_async(self, msg: M.Message) -> bool:
        """Under ``_rlock``: admission. True iff the upload entered the
        buffer; each refusal bumps one ``upload_stats`` counter and logs
        its reason."""
        c = msg.sender_id
        tag = msg.get(M.ARG_ROUND_IDX)
        fid = obs_trace.flow_id_of(msg.get(M.ARG_TRACE_CTX))
        v = self.round_idx if tag is None else int(tag)
        tau = self.round_idx - v
        if tau < 0:
            self._stat("dropped_future")
            obs_flight.record("drop_future", client=c, tagged=v,
                              version=self.round_idx)
            log.warning("server: dropping upload from %d tagged with "
                        "FUTURE version %d (current %d)", c, v,
                        self.round_idx)
            return False
        if tau > self.max_staleness:
            self._stat("dropped_stale")
            obs_flight.record("drop_stale", client=c, tagged=v,
                              tau=tau, version=self.round_idx)
            log.warning("server: dropping ancient upload from %d "
                        "(base version %d, current %d, staleness %d > "
                        "max_staleness %d)", c, v, self.round_idx, tau,
                        self.max_staleness)
            return False
        seq = msg.get(M.ARG_UPLOAD_SEQ)
        if seq is not None:
            if int(seq) <= self._seq_seen.get(c, -1):
                self._stat("dropped_duplicate")
                obs_flight.record("drop_duplicate", client=c,
                                  seq=int(seq), version=self.round_idx)
                log.warning("server: dropping re-delivered upload from "
                            "%d (seq %s <= watermark %d)", c, seq,
                            self._seq_seen[c])
                return False
            # the watermark moves at the gate: a re-delivery repeats the
            # verdict, never the processing (a duplicated NaN frame
            # strikes its sender once)
            self._seq_seen[c] = int(seq)
        elif v in self._contributed.get(c, ()):
            self._stat("dropped_duplicate")
            obs_flight.record("drop_duplicate", client=c, base_version=v,
                              version=self.round_idx)
            log.warning("server: dropping duplicate upload from %d for "
                        "base version %d (sender ships no upload_seq)",
                        c, v)
            return False
        if c in self._quarantined_now():
            self._stat("dropped_quarantined")
            obs_flight.record("drop_quarantined", client=c,
                              version=self.round_idx)
            log.warning("server: dropping upload from QUARANTINED silo "
                        "%d (version %d; window ends at version %d)",
                        c, self.round_idx, self._quarantine_until[c])
            return False
        if self.secure_quant is not None:
            from neuroimagedisttraining_tpu_torch.privacy import (
                secure_quant as sq,
            )

            frame = msg.get(M.ARG_MODEL_PARAMS)
            try:
                sq._validate_frame(frame, self.secure_quant)
                # a frame of another leaf set never reaches the fold
                if sq.SlotAccumulator._frame_sizes(frame) != \
                        self._sq_sizes:
                    raise ValueError(
                        "frame leaf structure differs from the model "
                        "(version skew)")
            except (ValueError, KeyError, TypeError) as e:
                self._stat("dropped_undecodable")
                obs_flight.record("drop_undecodable", client=c,
                                  base_version=v, error=str(e))
                log.warning("server: dropping invalid secure-quant frame "
                            "from %d (base version %d): %s", c, v, e)
                return False
            n = float(msg.get(M.ARG_NUM_SAMPLES))
            if not (np.isfinite(n) and n >= 0):
                raise ValueError(f"non-finite num_samples {n!r}")
            if seq is None:
                self._contributed.setdefault(c, set()).add(v)
            # no carry to the current base (the server cannot see the
            # update) and no non-finite gate (field elements are finite by
            # construction): the down-weighting alone handles staleness
            self._buffer_put(c, tau, n, {"frame": frame, "fid": fid})
            return True
        ref = self._ring[v]  # present: tau <= the ring's span
        try:
            decoded = self._decode(msg.get(M.ARG_MODEL_PARAMS), ref)
        except Exception as e:  # noqa: BLE001 — an undecodable frame is a
            # dropped upload, never a dead dispatch thread
            self._stat("dropped_undecodable")
            obs_flight.record("drop_undecodable", client=c,
                              base_version=v, error=str(e))
            log.warning("server: dropping undecodable upload from %d "
                        "(base version %d): %s", c, v, e)
            return False
        if not tree_all_finite(decoded):
            self._stat("dropped_nonfinite")
            obs_flight.record("reject_nonfinite", client=c,
                              base_version=v)
            self.byz_stats["nonfinite_rejected"] += 1
            log.warning("server: REJECTING non-finite upload from silo "
                        "%d (base version %d)", c, v)
            if self.quarantine_rounds > 0:
                self._strike(c, "non-finite upload")
            if seq is None:
                # a re-delivered copy of this frame cannot strike twice
                self._contributed.setdefault(c, set()).add(v)
            return False
        n = float(msg.get(M.ARG_NUM_SAMPLES))
        if not (np.isfinite(n) and n >= 0):
            raise ValueError(f"non-finite num_samples {n!r}")
        # staleness 0 passes through untouched (the equivalence pin)
        u_eff = (decoded if tau == 0
                 else carry_to_base(decoded, self.params, ref))
        if seq is None:  # a seq's watermark already moved at the gate
            self._contributed.setdefault(c, set()).add(v)
        self._buffer_put(c, tau, n, {"tree": u_eff, "fid": fid})
        return True

    def _buffer_put(self, c: int, tau: int, n: float,
                    payload: dict) -> None:
        """Under ``_rlock``: one buffer slot a sender. A silo that laps the
        buffer replaces its older entry, so a fast sign-flipping silo
        cannot fill f + 1 slots by pace alone and the weighting is not
        biased to fast silos."""
        for i, e in enumerate(self._buffer):
            if e["client"] == c:
                del self._buffer[i]
                self._stat("superseded_in_buffer")
                obs_flight.record("superseded_in_buffer", client=c,
                                  tau_old=int(e["tau"]), tau_new=int(tau),
                                  version=self.round_idx)
                log.info("server: upload from %d supersedes its own "
                         "buffered entry (tau %d -> %d)", c,
                         e["tau"], tau)
                break
        self._buffer.append({
            "client": c, "n": n, "tau": tau,
            "weight": staleness_weight(n, tau, self.staleness_alpha),
            **payload})
        if self._buffer[-1].get("fid") is not None \
                and obs_trace.TRACER.armed:
            # the upload's flow step at admission, inside its own slice
            with obs_trace.span("upload_admit", client=int(c)):
                obs_trace.flow("upload", self._buffer[-1]["fid"], "t",
                               client=int(c))
        self._obs_staleness.observe(int(tau))
        self._obs_buffer.set(len(self._buffer))
        obs_flight.record("accept", client=c, tau=int(tau),
                          version=self.round_idx)

    # ---- aggregation ----

    def _aggregate_buffer(self) -> None:
        """Under ``_rlock``: one aggregation over the buffer, in client-id
        order (the reduction's order never depends on arrivals): outlier
        scoring first (a silo quarantined by this buffer is left out of
        this very aggregation), then the weighted or defended mean on the
        server's device, then the version advances."""
        from neuroimagedisttraining_tpu_torch.core import robust

        t0 = time.perf_counter()
        entries = sorted(self._buffer, key=lambda e: e["client"])
        if self.secure_quant is not None:
            self._aggregate_buffer_secure(entries, t0)
            return
        senders = [e["client"] for e in entries]
        trees = [e["tree"] for e in entries]
        self._score_survivors(senders, trees)
        q = self._quarantined_now()
        if q & set(senders):
            kept = [e for e in entries if e["client"] not in q]
            self._stat("quarantine_discarded",
                       len(entries) - len(kept))
            entries = kept
        if not entries:
            # every buffered upload's sender was quarantined by this very
            # scoring: keep the model, refill the buffer
            log.warning("server: buffer emptied by quarantine at "
                        "version %d - skipping aggregation", self.round_idx)
            obs_flight.record("buffer_emptied_by_quarantine",
                              version=self.round_idx)
            self._buffer = []
            self._obs_buffer.set(0)
            return
        trees = [e["tree"] for e in entries]
        ws = [e["weight"] for e in entries]
        senders = [e["client"] for e in entries]
        defense = robust.effective_defense(
            self.defense, len(entries), self.byz_f, warn=log.warning)
        extra = None
        if defense == "none":
            self.params = survivor_weighted_mean(trees, ws, self.device)
        else:
            noises = None
            if defense == "weak_dp":
                # one generator a (sender, leaf), keyed by the version:
                # the synchronous server's draws
                like = _named_tensors(self.params, self.device)
                noises = [silo_noise(self.defense_seed, self.round_idx, s,
                                     like) for s in senders]
                dp = self._note_weak_dp(senders, ws)
                extra = {"weak_dp": dp} if dp is not None else None
            self.params = survivor_defended_mean(
                trees, ws, self.params, defense=defense,
                byz_f=self.byz_f, geomed_iters=self.geomed_iters,
                norm_bound=self.norm_bound, stddev=self.stddev,
                noises=noises, device=self.device)
        self.aggregate_seconds.append(time.perf_counter() - t0)
        self._advance_version(entries, senders, extra=extra)

    def _aggregate_buffer_secure(self, entries: list, t0: float) -> None:
        """Under ``_rlock``: one aggregation over secure-quant frames. The
        staleness weights fold inside the field as integers
        (``integer_weights``, derived again a buffer so a replay is bit for
        bit); the dequantized total over the integer mass is the weighted
        mean of the quantized updates. No plaintext exists here, so
        scoring and server-side defenses are out (refused at startup); the
        weak_dp ledger still charges (the silos added the noise)."""
        from neuroimagedisttraining_tpu_torch.privacy import (
            SlotAccumulator, integer_weights,
        )

        senders = [e["client"] for e in entries]
        ws = [e["weight"] for e in entries]
        try:
            w_int, denom = integer_weights(ws, self.secure_quant,
                                           self._sq_value_bound)
            acc = SlotAccumulator(self.secure_quant, like=self.params)
            for e, wi in zip(entries, w_int):
                acc.fold(e["frame"], weight_int=int(wi))
            new_params = acc.finalize(like=self.params,
                                      rescale=1.0 / denom)
        except (ValueError, KeyError, TypeError) as e:
            # a failed fold costs one buffer, never the dispatch thread;
            # the model keeps its version
            log.error("server: secure-quant aggregation at version %d "
                      "failed (%s: %s) - discarding the %d-upload "
                      "buffer, model unchanged", self.round_idx,
                      type(e).__name__, e, len(entries))
            self._stat("aggregation_discarded", len(entries))
            obs_flight.record("aggregation_discarded",
                              version=self.round_idx,
                              uploads=len(entries),
                              error=f"{type(e).__name__}: {e}")
            self._buffer = []
            self._obs_buffer.set(0)
            return
        self.params = new_params
        self.aggregate_seconds.append(time.perf_counter() - t0)
        extra = {"secure_quant": True,
                 "weights_int": [int(w) for w in w_int]}
        if self.defense == "weak_dp":
            dp = self._note_weak_dp(senders, ws)
            if dp is not None:
                extra["weak_dp"] = dp
        self._advance_version(entries, senders, extra=extra)

    def _advance_version(self, entries: list, senders: list,
                         extra: dict | None = None) -> None:
        """Under ``_rlock``: after an aggregation, the version moves on;
        the ring, dedup marks and history roll forward; FINISH at the
        end."""
        self._buffer = []
        self.round_idx += 1
        if obs_trace.TRACER.armed:
            # the aggregated uploads' flows end in one aggregate slice
            with obs_trace.span("aggregate", version=self.round_idx,
                                clients=len(senders)):
                for e in entries[:_FLOW_ENDS_MAX]:
                    if e.get("fid") is not None:
                        obs_trace.flow("upload", e["fid"], "f",
                                       version=self.round_idx)
        obs_flight.record("aggregate", version=self.round_idx,
                          clients=len(senders),
                          taus=[int(e["tau"]) for e in entries])
        self._obs_buffer.set(0)
        self._obs_round_gauge.set(self.round_idx)
        self._obs_k_eff.set(self._k_eff())
        # each version advance is a host boundary for the armed rules
        self._observe_health_boundary()
        self._ring[self.round_idx] = self.params
        floor = self.round_idx - self.max_staleness
        for old in [k for k in self._ring if k < floor]:
            del self._ring[old]
        for c, seen in self._contributed.items():
            # versions below the ring can only be stale-dropped now
            self._contributed[c] = {v for v in seen if v >= floor}
        self.history.append({
            "version": self.round_idx, "clients": len(senders),
            "contributors": senders,
            "taus": [int(e["tau"]) for e in entries],
            "weights": [float(e["weight"]) for e in entries],
            "t": time.monotonic(), **(extra or {})})
        if self.round_idx >= self.comm_round:
            self._broadcast_finish()
            self._done.set()
            # the selector flushes the queued FINISH frames before the
            # shutdown tears its write queues down
            drain = getattr(self.com_manager, "drain_sends", None)
            if drain is not None:
                drain(5.0)
            self.finish()

    def _k_eff(self) -> int:
        """Under ``_rlock``: the occupancy that triggers an aggregation.
        With one slot a sender, a buffer never holds more contributors
        than the cohort has live members: silos known to be gone
        (heartbeat suspects, quarantined) lower the threshold below
        ``buffer_k`` instead of deadlocking the federation. With
        heartbeats off a silent silo is a slow one, as for the
        synchronous server without a deadline."""
        gone = len(self._suspect | self._quarantined_now())
        return max(1, min(self.buffer_k, self.num_clients - gone))

    def _maybe_complete(self) -> None:
        """No barrier to complete; but the heartbeat monitor calls this on
        a new suspect, which may have lowered ``_k_eff`` below the
        buffer's occupancy."""
        if self._done.is_set() or not self._buffer:
            return
        if len(self._buffer) >= self._k_eff():
            self._aggregate_buffer()

    def _broadcast_finish(self) -> None:
        # only the ranks that ever registered wait for a FINISH
        for c in sorted(self._registered):
            self._send_tolerant(M.Message(M.MSG_TYPE_S2C_FINISH, 0, c))

    # ---- the audit ----

    def upload_audit(self) -> dict:
        """Every received upload is counted once, and every accepted one is
        in a recorded aggregation, still buffered, or counted as discarded
        or superseded: none lost, none counted twice."""
        with self._rlock:
            s = dict(self.upload_stats)
            dropped = sum(v for k, v in s.items()
                          if k.startswith("dropped_"))
            aggregated = sum(h["clients"] for h in self.history
                             if "version" in h)
            audit = {
                **s,
                "aggregated": aggregated,
                "buffered": len(self._buffer),
                "received_accounted":
                    s["received"] == s["accepted"] + dropped,
                "accepted_accounted":
                    s["accepted"] == (aggregated + len(self._buffer)
                                      + s["quarantine_discarded"]
                                      + s["aggregation_discarded"]
                                      + s["superseded_in_buffer"]),
            }
        if not (audit["received_accounted"]
                and audit["accepted_accounted"]):
            # a red audit is the post-mortem's trigger: the flight ring
            # holds the decisions the audit cannot reconcile
            obs_flight.record("audit_failure", version=self.round_idx,
                              audit={k: v for k, v in audit.items()
                                     if isinstance(v, (int, bool))})
            out = obs_flight.dump(reason="upload_audit failure")
            if out:
                log.error("server: upload audit FAILED (%s) - flight "
                          "recorder dumped to %s", audit, out)
            else:
                evs = obs_flight.events()
                log.error("server: upload audit FAILED (%s) - no "
                          "flight dump path configured; last %d of %d "
                          "flight events: %s", audit, min(20, len(evs)),
                          len(evs), evs[-20:])
        return audit
