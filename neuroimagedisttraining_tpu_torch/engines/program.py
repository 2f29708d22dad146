"""Round programs and dispatch: the reason table, the window planner and
the window runner (the reference package's ``engines/program.py``).

The reference compiles each engine's declared round into jitted programs
and, under ``--rounds_per_dispatch K``, runs K rounds as one ``lax.scan``
dispatch whose host reads wait for the window's end. The port keeps the
names and the plan and writes the rest in PyTorch: there is nothing to
jit, donate or scan.

- :data:`REASONS` is the reference's table of fallback reasons (the same
  keys, planes and messages); :func:`report_fallback` logs an engine's
  fallback line once and counts it in :data:`FALLBACKS` and in the
  registry's ``nidt_fallback_total{plane, engine, reason}``.
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

Checkpoints (``--checkpoint_dir``, ``--checkpoint_every``): a checkpoint
round ends its window, so a resumed run starts at a window's first round
(:meth:`FederatedEngine._ckpt_active`).

Under ``--health_stats`` the round's tail also computes its health stats
on the device (:func:`health_update_stats`, :func:`mask_health_stats`,
the reference's): they ride out with the round's outputs and are read in
the window's one host read, so they add no sync and change no bit of
training.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable

import numpy as np
import torch

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


def report_fallback(engine_name: str, key: str, line: str, *args,
                    sink=None) -> str:
    """Log the fallback line ``line % args`` followed by ``key``'s message
    to ``sink`` (an engine's experiment log; this module's logger where
    there is none), count it by (plane, engine, key) and return the
    message."""
    from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
    from neuroimagedisttraining_tpu_torch.obs import names as obs_names

    plane, msg = REASONS[key]
    FALLBACKS[(plane, engine_name, key)] = FALLBACKS.get(
        (plane, engine_name, key), 0) + 1
    obs_metrics.counter(
        obs_names.FALLBACK_TOTAL,
        "fast-path fallback announcements by plane, engine and reason "
        "(engines/program.py REASONS)",
        labelnames=("plane", "engine", "reason")).labels(
        plane=plane, engine=engine_name, reason=key).inc()
    (sink or log).info(line + ": %s", *args, msg)
    return msg


def health_update_stats(uploads: list[dict], ref: dict, new_params: dict,
                        w: torch.Tensor) -> dict:
    """The round's update stats (``obs/health.py`` ``UPDATE_STAT_NAMES``)
    on the device, in float32, from the parameters of the uploads the
    aggregation took (after the attack and the codec), the round's
    broadcast parameters ``ref``, the new global parameters and the
    clients' weights ``w``: each client's update L2 norm, the max, the
    median and their dispersion, each client's leave-one-out cosine to the
    aggregate update (against the aggregate less its own weighted share:
    with its own share a sign-flipping client's cosine turns back toward
    +1), their min and mean, and the norms of the new model and of the
    aggregate update. Nothing is read on the host."""
    C = len(uploads)
    dev = w.device
    sq = torch.zeros((C,), dtype=torch.float32, device=dev)
    dots = torch.zeros((C,), dtype=torch.float32, device=dev)
    agg_sq = torch.zeros((), dtype=torch.float32, device=dev)
    gsq = torch.zeros((), dtype=torch.float32, device=dev)
    for k, r in ref.items():
        r = r.to(torch.float32)
        n = new_params[k].to(torch.float32)
        du = (torch.stack([u[k] for u in uploads]).to(torch.float32)
              - r[None]).reshape(C, -1)
        da = (n - r).reshape(-1)
        sq = sq + torch.sum(du * du, dim=1)
        dots = dots + du @ da
        agg_sq = agg_sq + torch.sum(da * da)
        gsq = gsq + torch.sum(n.reshape(-1) ** 2)
    norms = torch.sqrt(sq)
    wf = w.to(torch.float32)
    p = wf / torch.clamp(torch.sum(wf), min=1e-12)
    loo_dot = dots - p * sq
    loo_sq = torch.clamp(agg_sq - 2.0 * p * dots + p * p * sq, min=0.0)
    cos = loo_dot / torch.clamp(norms * torch.sqrt(loo_sq), min=1e-12)
    s = torch.sort(norms).values  # the median of an even count: the mean
    med = (s[(C - 1) // 2] + s[C // 2]) * 0.5 if C % 2 == 0 else s[C // 2]
    top = torch.max(norms)
    return {
        "h_up_norms": norms, "h_up_max": top, "h_up_med": med,
        "h_cos_min": torch.min(cos), "h_cos_mean": torch.mean(cos),
        "h_disp": top / torch.clamp(med, min=1e-12),
        "h_gnorm": torch.sqrt(gsq), "h_agg_up": torch.sqrt(agg_sq),
        "h_cos": cos,
    }


def mask_health_stats(new_masks: list[dict], old_masks: list[dict] | None
                      ) -> dict:
    """The mask stats (``obs/health.py`` ``MASK_STAT_NAMES``) over the
    clients' masks (one dict a client, or one dict for a global mask): the
    kept fraction, the round-over-round overlap of the kept weights (1
    without ``old_masks``: a fixed mask) and its churn, on the device."""
    if isinstance(new_masks, dict):
        new_masks = [new_masks]
    if isinstance(old_masks, dict):
        old_masks = [old_masks]
    dev = next(iter(new_masks[0].values())).device
    kept = torch.zeros((), dtype=torch.int64, device=dev)
    both = torch.zeros((), dtype=torch.int64, device=dev)
    was = torch.zeros((), dtype=torch.int64, device=dev)
    total = 0.0
    for i, m in enumerate(new_masks):
        for k, v in m.items():
            mb = v > 0
            kept = kept + torch.sum(mb)
            total += float(v.numel())
            if old_masks is not None:
                ob = old_masks[i][k] > 0
                both = both + torch.sum(mb & ob)
                was = was + torch.sum(ob)
    density = kept.to(torch.float32) / max(total, 1.0)
    if old_masks is None:
        overlap = torch.ones((), dtype=torch.float32, device=dev)
    else:
        overlap = both.to(torch.float32) / torch.clamp(
            was.to(torch.float32), min=1.0)
    return {"h_mask_density": density, "h_mask_overlap": overlap,
            "h_mask_churn": 1.0 - overlap}


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

    def cohort_fallback_key(self, flat: bool = False) -> str | None:
        """Why the engine runs unsharded even when ``--client_mesh`` asks
        for the sharded round: a :data:`REASONS` key, or None. ``flat``:
        the answer for the mesh's entries row-major, a two-level mesh as
        a 1-D one (where its ranks split the round)."""
        eng = self.eng
        if self.stages is None or not eng.supports_cohort_sharding:
            return eng.cohort_fallback_key()
        if not flat and eng.mesh is not None \
                and len(eng.mesh.axis_names) != 1:
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
                (eng.log or log).info(
                    "################ round %d: %s (fused window of %d)",
                    round_idx + off, eng.cohort_label, k)
            return WindowInputs(sampled=None, k=k)
        sampled, k = self.window_sampling(round_idx, k)
        for off, s in enumerate(sampled):
            (eng.log or log).info(
                "################ round %d: clients %s (fused window of %d)",
                round_idx + off, s.tolist(), k)
        return WindowInputs(sampled=sampled, k=k)

    # ---------- the window runner ----------

    def stream_window(self, sampled: list, next_round: int) -> list[dict]:
        """A streamed window's training rows, one fetch for its rounds
        (the feed's ``get_window``), each round's as a dict client ->
        ``ClientRows``; the next window's fetch starts behind it unless the
        window ends at an evaluation, whose test walks come first."""
        from neuroimagedisttraining_tpu_torch.engines.base import ClientRows

        eng = self.eng
        X, y, _ = eng.stream.get_window(sampled)
        out = [{int(c): ClientRows(X[off, j], y[off, j],
                                   int(eng.n_train[c]))
                for j, c in enumerate(ids)}
               for off, ids in enumerate(sampled)]
        last = next_round - 1
        if next_round < eng.cfg.fed.comm_round \
                and not eng.is_eval_round(last):
            k = self.dispatch_window(next_round)
            if k > 1:
                nxt, _ = self.window_sampling(next_round, k)
                eng.stream.prefetch_window(nxt)
        return out

    def run_window(self, carry: tuple, round_idx: int, k: int):
        """Rounds ``[round_idx, round_idx + k)`` of the engine's
        ``window_round``, with no host read between them. Returns
        ``(carry, outs, wi)``: the carry after the last round, each round's
        dict of device outputs, and the :class:`WindowInputs` (``wi.k`` may
        have shrunk)."""
        eng = self.eng
        wi = self.window_inputs(round_idx, k)
        window = (self.stream_window(wi.sampled, round_idx + wi.k)
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
                outs.append({**o, **eng.take_health()})
        finally:
            eng._round_rows = None
        return carry, outs, wi
