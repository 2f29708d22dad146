"""Round programs and dispatch: the reason table, the window planner and
the window runner (the reference package's ``engines/program.py``).

The reference compiles each engine's declared round into jitted programs
and, under ``--rounds_per_dispatch K``, runs K rounds as one ``lax.scan``
dispatch whose host reads wait for the window's end. The port keeps the
names and the plan and writes the rest in PyTorch: there is nothing to
jit, donate or scan.

- :data:`REASONS` is the reference's table of fallback reasons (the same
  keys, planes and messages); :func:`report_fallback` logs an engine's
  fallback line once and counts it in :data:`FALLBACKS` (the reference's
  ``nidt_fallback_total`` counter belongs to the observability plane the
  port does not have yet).
- :class:`RoundStages` is what an engine declares of its round: only the
  two facts the planner reads (whether the round gathers the sampled
  cohort, an engine's extra host hook). An engine without a declared
  round answers ``no-fused-body``.
- :class:`RoundProgram` holds the planner: the fallback keys, the window
  length (:meth:`~RoundProgram.dispatch_window`: evaluation, the last
  round, checkpoints and an engine's extra hook land on a window's last
  round), the window's cohorts (:meth:`~RoundProgram.window_sampling`,
  shrunk to the longest prefix of equal size under a crash schedule) and
  :meth:`~RoundProgram.run_window`, which runs the engine's own round
  function K times with every host read of the window deferred to its
  end: the losses, the non-finite counts and the privacy charge. On a
  CUDA device the local steps of every round, in a window or not, run as
  CUDA graphs (``core/graphs.py``); ``built`` counts their captures and
  ``dispatches`` their replays. On one device a window of K rounds is bit
  for bit K single rounds, the reference's own pin.

Checkpoints are not ported yet: :meth:`FederatedEngine._ckpt_active` is
False, as in a reference run without ``--checkpoint_dir``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable

import numpy as np

log = logging.getLogger(__name__)

#: reason key -> (plane, message), the reference's table
REASONS: dict[str, tuple[str, str]] = {
    # -- fused multi-round dispatch (plane "fused") --
    "no-fused-body": ("fused", (
        "engine has no fused round body (host-side state between "
        "rounds)")),
    "streaming-host-data": ("fused", (
        "streaming rounds cross the host for data every round")),
    "wire-codec-host-bytes": ("fused", (
        "--wire_codec accounts encoded bytes on the host every round")),
    "mpc-host-stage": ("fused", (
        "the MPC aggregation stage is host-driven between rounds")),
    # -- cohort sharding (plane "sharding") --
    "no-sharded-body": ("sharding", (
        "engine has no cohort-sharded round body (its round crosses the "
        "host or exchanges per-client state outside the declared-stage "
        "shape)")),
    "two-level-mesh": ("sharding", (
        "two-level (silos, clients) mesh routes aggregation silo-first "
        "(parallel/hierarchical.py); cohort sharding arms on 1-D client "
        "meshes")),
    "one-device": ("sharding", (
        "only one device visible — the unsharded round IS the "
        "single-device program")),
    "streaming-sharded-feed": ("sharding", (
        "streaming rounds host-stage each round's shards; the streamed "
        "feed already device_puts them client-sharded over the mesh")),
    "batch-order-replacement": ("sharding", (
        "batch_order=replacement draws per-step randint batches inside "
        "the shard_map partition, where the partitioned RNG+gather "
        "lowering miscompiles on this toolchain (measured, "
        "parallel/cohort.py); the shuffle path hoists its permutations "
        "out of the partition — i.i.d. per-step draws cannot be "
        "hoisted")),
    "gossip-mesh-collectives": ("sharding", (
        "dispfl's decentralized round already runs client-sharded "
        "gossip collectives on the mesh (parallel/gossip.py); "
        "--client_mesh adds nothing")),
    "mpc-host-boundary": ("sharding", (
        "turboaggregate's round crosses the host at the MPC share "
        "boundary every round (quantize/share/aggregate models the "
        "client<->server link); no sharded round body")),
    "cohort-not-tiling": ("sharding", (
        "the full client axis does not tile the client mesh (the data "
        "layer pads resident cohorts to a device multiple; this one is "
        "not)")),
    # -- the distributed transport (distributed/run.py startup notes) --
    "distributed-control-plane": ("fused", (
        "the distributed transport dispatches one round at a time "
        "(every round crosses the control plane: broadcast/upload/"
        "aggregate over sockets)")),
    "distributed-no-client-axis": ("sharding", (
        "the distributed transport has no in-process client axis to "
        "shard (each rank trains its own silo) — flag accepted for "
        "config parity with the main CLI only")),
    # -- autotuner recipes (plane "recipe", tune/recipe.py) --
    "recipe-override": ("recipe", (
        "an explicit CLI flag overrides the loaded recipe's value for "
        "this knob (--recipe applies as config DEFAULTS; flags the "
        "operator spells win)")),
}

#: fallback announcements by (plane, engine, reason key)
FALLBACKS: dict[tuple[str, str, str], int] = {}


def reason(key: str) -> str:
    """The logged message for a fallback ``key`` (KeyError on unknown
    keys)."""
    return REASONS[key][1]


def report_fallback(engine_name: str, key: str, line: str, *args) -> str:
    """Log the fallback line ``line % args`` followed by ``key``'s message,
    count it by (plane, engine, key) and return the message."""
    plane, msg = REASONS[key]
    FALLBACKS[(plane, engine_name, key)] = FALLBACKS.get(
        (plane, engine_name, key), 0) + 1
    log.info(line + ": %s", *args, msg)
    return msg


@dataclasses.dataclass(frozen=True)
class RoundStages:
    """An engine's declared round, as far as the planner reads it.

    ``gathers_cohort``: the round trains the sampled clients (False: every
    client, D-PSGD- and Local-style; the full client axis must then tile a
    client mesh). ``extra_hooked``: an extra host-boundary predicate of
    the round index (D-PSGD's every-100-rounds fine-tune)."""

    gathers_cohort: bool = True
    extra_hooked: Callable | None = None


@dataclasses.dataclass
class WindowInputs:
    """A window's host prologue: the per-round cohorts (None for engines
    that train every client) and its length, which ``window_sampling`` may
    have shrunk."""

    sampled: list | None
    k: int


class RoundProgram:
    """The planner and window runner of one engine
    (``FederatedEngine.program``)."""

    def __init__(self, eng, stages: RoundStages | None):
        self.eng = eng
        self.stages = stages

    @property
    def built(self) -> int:
        """Local-step graphs captured (the reference's compilations)."""
        return self.eng.trainer.graph_stats[0]

    @property
    def dispatches(self) -> int:
        """Local-step graph replays (the reference's dispatches)."""
        return self.eng.trainer.graph_stats[1]

    # ---------- fallback reporting ----------

    def fused_fallback_key(self) -> str | None:
        """Why the engine runs one round at a time even when
        ``--rounds_per_dispatch K`` asks for windows: a :data:`REASONS`
        key, or None."""
        if self.stages is None:
            return "no-fused-body"
        if self.eng.stream is not None \
                and not self.eng.supports_fused_streaming:
            return "streaming-host-data"
        if self.eng.wire_spec is not None:
            return "wire-codec-host-bytes"
        return None

    def cohort_fallback_key(self) -> str | None:
        """Why the engine runs unsharded even when ``--client_mesh`` asks
        for the sharded round: a :data:`REASONS` key, or None."""
        eng = self.eng
        if self.stages is None or not eng.supports_cohort_sharding:
            return eng.cohort_fallback_key()
        if eng.mesh is not None and len(eng.mesh.axis_names) != 1:
            return "two-level-mesh"
        if eng.mesh is not None and eng.mesh.devices.size == 1:
            return "one-device"
        if eng.stream is not None:
            return "streaming-sharded-feed"
        if eng.cfg.optim.batch_order != "shuffle":
            return "batch-order-replacement"
        if not self.stages.gathers_cohort \
                and eng.num_clients % eng.mesh.devices.size != 0:
            return "cohort-not-tiling"
        return None

    # ---------- window planning ----------

    def dispatch_window(self, round_idx: int) -> int:
        """Length of the window starting at ``round_idx``: up to
        ``rounds_per_dispatch``, stopping so that a round with a host hook
        (evaluation, the last round, a checkpoint, the engine's extra
        hook) is the window's last."""
        eng = self.eng
        f = eng.cfg.fed
        K = max(1, int(f.rounds_per_dispatch))
        extra = self.stages.extra_hooked if self.stages else None

        def hooked(r: int) -> bool:
            return (r % f.frequency_of_the_test == 0
                    or r == f.comm_round - 1
                    or (eng._ckpt_active()
                        and (r + 1) % eng.cfg.checkpoint_every == 0)
                    or (extra is not None and extra(r)))

        k = 1
        while (k < K and round_idx + k < f.comm_round
               and not hooked(round_idx + k - 1)):
            k += 1
        return k

    def window_sampling(self, round_idx: int, k: int
                        ) -> tuple[list[np.ndarray], int]:
        """The window's per-round cohorts (``np.random.seed(round)`` each)
        and its length: where a fault schedule changes the survivor count
        mid-window, the longest prefix of equal cohort sizes."""
        eng = self.eng
        sampled = [eng.client_sampling(r)
                   for r in range(round_idx, round_idx + k)]
        keep = 1
        while keep < len(sampled) and \
                len(sampled[keep]) == len(sampled[0]):
            keep += 1
        return sampled[:keep], keep

    def window_inputs(self, round_idx: int, k: int) -> WindowInputs:
        """The window's cohorts and the per-round log lines the single
        rounds would have emitted, in round order."""
        eng = self.eng
        if self.stages is not None and not self.stages.gathers_cohort:
            for off in range(k):
                log.info("################ round %d: %s (fused window of "
                         "%d)", round_idx + off, eng.cohort_label, k)
            return WindowInputs(sampled=None, k=k)
        sampled, k = self.window_sampling(round_idx, k)
        for off, s in enumerate(sampled):
            log.info("################ round %d: clients %s (fused window "
                     "of %d)", round_idx + off, s.tolist(), k)
        return WindowInputs(sampled=sampled, k=k)

    # ---------- the window runner ----------

    def run_window(self, carry: tuple, round_idx: int, k: int):
        """Rounds ``[round_idx, round_idx + k)`` of the engine's
        ``window_round``, with no host read between them. Returns
        ``(carry, outs, wi)``: the carry after the last round, each round's
        dict of device outputs, and the :class:`WindowInputs` (``wi.k`` may
        have shrunk)."""
        eng = self.eng
        wi = self.window_inputs(round_idx, k)
        window = (eng.stream_window(wi.sampled, round_idx + wi.k)
                  if eng.stream is not None else None)
        outs = []
        try:
            for off in range(wi.k):
                r = round_idx + off
                sampled = wi.sampled[off] if wi.sampled is not None else None
                if window is not None:
                    eng._round_rows = window[off]
                else:
                    eng.plan_walks(r)
                carry, o = eng.window_round(carry, r, sampled)
                outs.append(o)
        finally:
            eng._round_rows = None
        return carry, outs, wi
