"""The profile session (the reference package's ``obs/probe.py``): a
manifest of probes run through the shipped engines into one artifact.

Each :class:`Probe` names one config cell (precision x fused update x
remat x client mesh x rounds a dispatch x batch). The session builds the
cell's FedAvg engine with ``create_engine("fedavg", ...)`` on a seeded
synthetic federation, runs ``engine.train()`` (the window planner, the
CUDA-graph steps and the mesh that production runs take) with the
dispatch-boundary profiler armed (``obs/compute.py``), and writes one JSON
artifact:

- per probe: wall seconds, ms a round, the round and window dispatches
  (``dispatches``, the reference's count), the step-graph captures
  (``compiles``) and replays (``step_replays``), sustained TFLOP/s and
  MFU of the last boundary window, the kernels' launches
  (``ops/_cuda.py``) and, on a card, the memory reserved before the
  probe, at its peak and after the engine's release;
- once: one training step under ``FlopCounterMode`` against the analytic
  count, and its peak memory (``xla.train_step``,
  ``obs/compute.py`` ``analyze_train_step``);
- a live ``/metrics`` and ``/healthz`` scrape over HTTP
  (``metrics_scrape_ok``, ``healthz_compute_ok``).

A probe that raises is recorded with its error and fails the session;
nothing gives way to the CPU or to a plain kernel. Entry points::

    python -m neuroimagedisttraining_tpu_torch.obs.probe [--out X.json] \\
        [--manifest M.json] [--trace_out T.json] [--virtual_devices N] \\
        [--device cuda|cpu]
    python -m neuroimagedisttraining_tpu_torch ... --profile_session X.json \\
        [--profile_manifest M.json]

Both exit 0 only when :func:`session_ok`. The environment sizes the
cells, as in the reference: ``PROFILE_MODEL`` (default ``3dcnn_tiny``),
``PROFILE_SHAPE`` (``12,14,12``), ``PROFILE_BATCH`` (8),
``PROFILE_LOCAL`` (16 rows a client), ``PROFILE_CLIENTS`` (4) and
``PROFILE_ROUNDS`` (5). ``--manifest`` replaces the default probe list
with a JSON list of ``{"name", "cell"}`` objects.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback

__all__ = ["Probe", "default_manifest", "load_manifest", "run_probe",
           "run_session", "session_ok", "main", "validate_cell_value",
           "remat_policy"]

#: config-cell keys a probe may set; anything else in a manifest cell
#: is a spelling error and fails loudly at load (declarative probes
#: must not silently ignore a knob)
CELL_KEYS = ("precision", "fused_update", "remat", "client_mesh",
             "rounds_per_dispatch", "batch")

#: legal remat spellings in a cell: the CLI policy strings plus the
#: historic manifest booleans (True -> full remat, False -> off)
REMAT_CELL_VALUES = ("none", "stem", "all")


def remat_policy(value) -> bool | str:
    """Map a cell's remat value onto ``create_model(remat=...)``: bools
    pass through, the CLI policy strings map {"none": off, "stem":
    stem-only, "all": full}."""
    if isinstance(value, bool):
        return value
    return {"none": False, "stem": "stem", "all": True}[value]


def validate_cell_value(key: str, value) -> None:
    """Per-axis domain check (ValueError on violation), with the
    reference's messages."""
    def die(expect: str) -> None:
        raise ValueError(f"cell key {key}={value!r} out of domain: "
                         f"expected {expect}")

    if key == "precision":
        from neuroimagedisttraining_tpu_torch.core.optim import PRECISIONS
        if value not in PRECISIONS:
            die(f"one of {PRECISIONS}")
    elif key == "fused_update":
        if not isinstance(value, bool):
            die("a bool")
    elif key == "remat":
        if not isinstance(value, bool) and value not in REMAT_CELL_VALUES:
            die(f"a bool or one of {REMAT_CELL_VALUES}")
    elif key == "client_mesh":
        if isinstance(value, bool) or not isinstance(value, int) or value < 0:
            die("an int >= 0")
    elif key == "rounds_per_dispatch":
        if isinstance(value, bool) or not isinstance(value, int) or value < 1:
            die("an int >= 1")
    elif key == "batch":
        if isinstance(value, bool) or not isinstance(value, int) or value < 1:
            die("an int >= 1")
    else:
        raise ValueError(f"unknown cell key {key!r}; declarable keys: "
                         f"{CELL_KEYS}")


@dataclasses.dataclass(frozen=True)
class Probe:
    """One declared probe: a name and the config cell it pins. Unset
    knobs keep the shipped defaults."""

    name: str
    cell: dict

    def __post_init__(self):
        bad = set(self.cell) - set(CELL_KEYS)
        if bad:
            raise ValueError(
                f"probe {self.name!r} names unknown cell keys "
                f"{sorted(bad)}; declarable keys: {CELL_KEYS}")
        for key, value in self.cell.items():
            try:
                validate_cell_value(key, value)
            except ValueError as e:
                raise ValueError(f"probe {self.name!r}: {e}") from None


def default_manifest(n_devices: int = 1) -> tuple[Probe, ...]:
    """The reference's probe list: the precision pair, the fused update,
    remat, the K = 4 window and, with more than one mesh entry, the
    cohort-sharded round."""
    probes = [
        Probe("fp32_baseline", {"precision": "fp32"}),
        Probe("bf16", {"precision": "bf16_mixed"}),
        Probe("bf16_fused", {"precision": "bf16_mixed",
                             "fused_update": True}),
        Probe("bf16_remat", {"precision": "bf16_mixed", "remat": True}),
        Probe("fused_dispatch_k4", {"precision": "fp32",
                                    "rounds_per_dispatch": 4}),
    ]
    if n_devices > 1:
        probes.append(Probe("cohort_sharded",
                            {"precision": "fp32",
                             "client_mesh": n_devices}))
    return tuple(probes)


def load_manifest(path: str) -> tuple[Probe, ...]:
    """A manifest file is a JSON list of ``{"name", "cell"}`` objects."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, list) or not doc:
        raise ValueError(f"manifest {path}: expected a non-empty JSON "
                         "list of {name, cell} objects")
    return tuple(Probe(p["name"], dict(p.get("cell", {}))) for p in doc)


def _env_meta() -> dict:
    return {
        "model": os.environ.get("PROFILE_MODEL", "3dcnn_tiny"),
        "shape": tuple(int(s) for s in os.environ.get(
            "PROFILE_SHAPE", "12,14,12").split(",")),
        "batch": int(os.environ.get("PROFILE_BATCH", 8)),
        "n_local": int(os.environ.get("PROFILE_LOCAL", 16)),
        "clients": int(os.environ.get("PROFILE_CLIENTS", 4)),
        "rounds": int(os.environ.get("PROFILE_ROUNDS", 5)),
    }


def default_out() -> str:
    """The artifact's default path, in the temporary directory."""
    return os.path.join(tempfile.gettempdir(), "nidt_profile",
                        "profile_session.json")


def mesh_entries(device, virtual_devices: int = 0) -> list:
    """The session's mesh entries: ``virtual_devices`` entries on
    ``device`` (``parallel/mesh.py``), else every visible device of its
    type."""
    from neuroimagedisttraining_tpu_torch.parallel.mesh import (
        virtual_devices as virtual, visible_devices,
    )

    return (virtual(virtual_devices, device) if virtual_devices
            else visible_devices(device))


def _make_fed(meta: dict, device):
    """The seeded synthetic federation at the session shape, made on
    ``device`` by a seeded generator: uint8 volumes ``[C, n_local, *shape]``,
    int32 labels, the first 4 rows of each client as its test rows."""
    import numpy as np
    import torch

    from neuroimagedisttraining_tpu_torch.data.federate import FederatedData

    gen = torch.Generator(device=device).manual_seed(20)
    C, n_local = meta["clients"], meta["n_local"]
    X = torch.randint(0, 255, (C, n_local) + tuple(meta["shape"]),
                      generator=gen, device=device, dtype=torch.uint8)
    y = torch.randint(0, 2, (C, n_local), generator=gen, device=device,
                      dtype=torch.int32)
    return FederatedData(X_train=X, y_train=y,
                         n_train=np.full(C, n_local, np.int64),
                         X_test=X[:, :4], y_test=y[:, :4],
                         n_test=np.full(C, 4, np.int64))


def _round_dispatches(engine: str) -> int:
    """The engine's round and window dispatches so far
    (``nidt_dispatch_ms`` observations on those programs)."""
    from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
    from neuroimagedisttraining_tpu_torch.obs import names as N

    snap = obs_metrics.REGISTRY.snapshot().get(N.DISPATCH_MS) or {}
    return int(sum(c["value"]["count"] for c in snap.get("values", ())
                   if c["labels"].get("engine") == engine
                   and c["labels"].get("program") in ("round", "window")))


def run_probe(probe: Probe, meta: dict, fed, device, entries=None) -> dict:
    """One probe through the shipped engine: the cell's FedAvg engine
    (``create_engine``), ``engine.train()`` (which ends in the engine's
    release of its step graphs), then the counts off its round program,
    the MFU and TFLOP/s samples off the profiler and, on a card, the
    memory reserved before, at the peak and after the release."""
    import torch

    from neuroimagedisttraining_tpu_torch.config import (
        DataConfig, ExperimentConfig, FedConfig, OptimConfig,
    )
    from neuroimagedisttraining_tpu_torch.core.optim import compute_dtype
    from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
    from neuroimagedisttraining_tpu_torch.engines import create_engine
    from neuroimagedisttraining_tpu_torch.models import create_model
    from neuroimagedisttraining_tpu_torch.obs import compute as obs_compute
    from neuroimagedisttraining_tpu_torch.ops import _cuda
    from neuroimagedisttraining_tpu_torch.parallel.mesh import make_mesh

    device = torch.device(device)
    entries = mesh_entries(device) if entries is None else entries
    cell = dict(probe.cell)
    cm = int(cell.get("client_mesh", 0))
    if cm > 1 and len(entries) < cm:
        return {"config": cell, "ran": False,
                "skip_reason": f"client_mesh={cm} needs {cm} devices, "
                               f"{len(entries)} visible "
                               "(--virtual_devices provisions them)"}
    precision = cell.get("precision", "fp32")
    optim = OptimConfig(lr=1e-3,
                        batch_size=int(cell.get("batch", meta["batch"])),
                        epochs=1, precision=precision,
                        fused_update=bool(cell.get("fused_update", False)))
    cfg = ExperimentConfig(
        model=meta["model"], num_classes=1, algorithm="fedavg",
        data=DataConfig(dataset="synthetic"), optim=optim,
        fed=FedConfig(client_num_in_total=meta["clients"],
                      comm_round=meta["rounds"],
                      rounds_per_dispatch=int(
                          cell.get("rounds_per_dispatch", 1)),
                      client_mesh=cm,
                      frequency_of_the_test=10 ** 9),
        tag=f"probe-{probe.name}")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        reserved0 = torch.cuda.memory_reserved(device)
        torch.cuda.reset_peak_memory_stats(device)
    trainer = LocalTrainer(
        create_model(meta["model"], tuple(meta["shape"]), 1,
                     dtype=compute_dtype(precision),
                     remat=remat_policy(cell.get("remat", False))),
        optim, device, torch.Generator(device=device).manual_seed(cfg.seed))
    mesh = make_mesh(num_devices=cm, devices=entries) if cm > 1 else None
    engine = create_engine("fedavg", cfg, fed, trainer, mesh=mesh)
    # a probe never inherits its predecessor's MFU/TFLOPs samples: a
    # cell whose run closes no boundary reports None
    obs_compute.PROFILER.clear_samples()
    dispatched = _round_dispatches(engine.name)
    launched = _cuda.counts()
    t0 = time.perf_counter()
    result = engine.train()
    wall = time.perf_counter() - t0
    prof = obs_compute.PROFILER.snapshot()
    hist = result.get("history") or [{}]
    out = {
        "config": cell,
        "ran": True,
        "skip_reason": None,
        "wall_s": round(wall, 4),
        "round_ms": round(wall / meta["rounds"] * 1e3, 2),
        "dispatches": _round_dispatches(engine.name) - dispatched,
        "compiles": int(engine.program.built),
        "step_replays": int(engine.program.dispatches),
        "sustained_tflops": prof.get("last_sustained_tflops"),
        "mfu": prof.get("last_mfu"),
        "train_loss_final": hist[-1].get("train_loss"),
        "launches": {k: n - launched.get(k, 0)
                     for k, n in _cuda.counts().items()},
    }
    if cuda:
        out["memory"] = {
            "reserved_before_bytes": int(reserved0),
            "peak_reserved_bytes": int(
                torch.cuda.max_memory_reserved(device)),
            "reserved_after_release_bytes": int(
                torch.cuda.memory_reserved(device))}
    return out


def _scrape(port: int) -> tuple[bool, bool]:
    """(metrics_scrape_ok, healthz_compute_ok): a real HTTP scrape of the
    live endpoint."""
    from urllib.request import urlopen

    from neuroimagedisttraining_tpu_torch.obs import names as obs_names

    try:
        body = urlopen(f"http://127.0.0.1:{port}/metrics",
                       timeout=5).read().decode()
        # _bucket is the Prometheus exposition suffix of the histogram
        metrics_ok = (obs_names.DISPATCH_MS + "_bucket" in body
                      and obs_names.COMPILES_TOTAL in body
                      and (obs_names.SUSTAINED_TFLOPS in body
                           or obs_names.MFU in body))
        health = json.loads(urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=5).read())
        comp = health.get("compute") or {}
        health_ok = (comp.get("dispatches", 0) > 0
                     and comp.get("compiles", 0) > 0)
        return bool(metrics_ok), bool(health_ok)
    except Exception:  # noqa: BLE001 — the artifact records the failure
        return False, False


def _train_step(meta: dict, fed, device) -> dict:
    """One fp32 training step at the session shape under the FLOP counter
    (``analyze_train_step``), on a batch of the federation's rows. The
    model is built without the fast stem: the counter sees aten
    operators only."""
    import torch

    from neuroimagedisttraining_tpu_torch.config import OptimConfig
    from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
    from neuroimagedisttraining_tpu_torch.models import create_model
    from neuroimagedisttraining_tpu_torch.obs import compute as obs_compute

    fast = os.environ.pop("NIDT_FAST_STEM", None)
    try:
        model = create_model(meta["model"], tuple(meta["shape"]), 1)
    finally:
        if fast is not None:
            os.environ["NIDT_FAST_STEM"] = fast
    trainer = LocalTrainer(model, OptimConfig(lr=1e-3,
                                              batch_size=meta["batch"],
                                              epochs=1),
                           device, torch.Generator(device=device))
    params = {k: v.detach() for k, v in trainer.model.named_parameters()}
    bstats = {k: v for k, v in trainer.model.named_buffers()}
    b = meta["batch"]
    return obs_compute.analyze_train_step(
        trainer, params, bstats, fed.X_train[0, :b], fed.y_train[0, :b])


def run_session(manifest: tuple[Probe, ...], out_path: str,
                trace_out: str = "", device="cuda",
                virtual_devices: int = 0) -> dict:
    """The whole session: arm the telemetry, run every probe through the
    shipped engines, reconcile the FLOP counts once, scrape the live
    endpoint, write the artifact."""
    import torch

    from neuroimagedisttraining_tpu_torch.device import resolve_device
    from neuroimagedisttraining_tpu_torch.obs import compute as obs_compute
    from neuroimagedisttraining_tpu_torch.obs import trace as obs_trace
    from neuroimagedisttraining_tpu_torch.obs.http import MetricsServer

    dev = resolve_device(device)
    entries = mesh_entries(dev, virtual_devices)
    meta = _env_meta()
    if trace_out:
        obs_trace.arm(trace_out, tags={"session": "profile"})
    srv = MetricsServer(
        0, host="127.0.0.1", health_probe=lambda: {
            "compute": obs_compute.PROFILER.health()})
    probes: dict[str, dict] = {}
    completed = 0
    t0 = time.perf_counter()
    try:
        fed = _make_fed(meta, dev)
        for probe in manifest:
            print(f"[profile] probe {probe.name}: {probe.cell}",
                  flush=True)
            try:
                probes[probe.name] = run_probe(probe, meta, fed, dev,
                                               entries)
            except Exception as e:  # noqa: BLE001 — one blown probe
                # must not lose the completed probes' results: recorded,
                # and probes_completed < n_probes fails the session
                traceback.print_exc()
                probes[probe.name] = {
                    "config": dict(probe.cell), "ran": False,
                    "skip_reason": f"error: {type(e).__name__}: {e}"}
            if probes[probe.name]["ran"]:
                completed += 1
            else:
                print(f"[profile]   skipped: "
                      f"{probes[probe.name]['skip_reason']}", flush=True)
        step = _train_step(meta, fed, dev)
        metrics_ok, health_ok = _scrape(srv.port)
    finally:
        # the endpoint thread and the armed tracer must not outlive the
        # session, even when a probe or the reconciliation raises
        srv.close()
        if trace_out:
            obs_trace.dump()
            obs_trace.disarm()

    fingerprint = json.dumps({p.name: p.cell for p in manifest},
                             sort_keys=True)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    doc = {
        "metric": "profile_session",
        "meta": {
            **{k: (list(v) if isinstance(v, tuple) else v)
               for k, v in meta.items()},
            "device_name": name,
            "n_devices": len(entries),
            "peak_flops": obs_compute.peak_flops_estimate(
                "fp32", name) or None,
            "torch": torch.__version__,
        },
        "probes": probes,
        "xla": {"train_step": step},
        "session": {
            "n_probes": len(manifest),
            "probes_completed": completed,
            "structural_fingerprint": fingerprint,
            "metrics_scrape_ok": metrics_ok,
            "healthz_compute_ok": health_ok,
            "wall_s": round(time.perf_counter() - t0, 2),
        },
        "notes": (
            "Shipped-engine probes (engine.train()) with the dispatch-"
            "boundary profiler armed (obs/compute.py). dispatches counts "
            "round and window dispatches, compiles and step_replays the "
            "step graphs' captures and replays; wall and TFLOP/s drift "
            "with the machine; MFU publishes only where the card's peak "
            "is known (NIDT_PEAK_FLOPS / --peak_flops override). "
            "xla.train_step is one fp32 step under FlopCounterMode against "
            "the analytic count. CPU numbers are the harness's, not a "
            "card's."),
    }
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    print(f"[profile] session artifact: {out_path} "
          f"({completed}/{len(manifest)} probes, "
          f"scrape_ok={metrics_ok})", flush=True)
    return doc


def session_ok(doc: dict) -> bool:
    """Every declared probe ran and both live scrapes held (``/metrics``
    samples and the ``/healthz`` compute block): the exit code of this
    module's CLI and of ``--profile_session``."""
    s = doc["session"]
    return bool(s["probes_completed"] == s["n_probes"]
                and s["metrics_scrape_ok"] and s["healthz_compute_ok"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m neuroimagedisttraining_tpu_torch.obs.probe",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=str, default=default_out(),
                    help="artifact path (default: nidt_profile/"
                         "profile_session.json in the temporary directory)")
    ap.add_argument("--manifest", type=str, default="",
                    help="JSON probe manifest replacing the default "
                         "list (a [{name, cell}] array)")
    ap.add_argument("--trace_out", type=str, default="",
                    help="also write the session's host-span Chrome "
                         "trace here")
    ap.add_argument("--virtual_devices", type=int, default=0,
                    help="a mesh of N entries on the device (arms the "
                         "cohort_sharded probe with one card)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from neuroimagedisttraining_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    manifest = (load_manifest(args.manifest) if args.manifest
                else default_manifest(len(mesh_entries(
                    dev, args.virtual_devices))))
    doc = run_session(manifest, args.out, trace_out=args.trace_out,
                      device=dev, virtual_devices=args.virtual_devices)
    return 0 if session_ok(doc) else 1


if __name__ == "__main__":
    sys.exit(main())
