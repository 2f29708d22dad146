"""Autotune CLI (the reference package's ``tune/__main__.py``): search
the declared space on this hardware, emit the per-device-kind recipe +
the session artifact.

::

    python -m neuroimagedisttraining_tpu_torch.tune \
        --backend virtual --seed 20 --device cpu --virtual_devices 2 \
        --out /tmp/recipes/cpu.json --session_out /tmp/autotune.json \
        --journal /tmp/tune.jsonl --validate_winner

Backends: ``virtual`` scores cells through the seeded deterministic
cost model (tune/search.py ``virtual_measure`` — the CPU harness's
artifact generator, byte-reproducible, the reference's bytes);
``driver`` measures every cell through the shipped ``engine.train()``
probe driver on ``--device`` (the card by default; wall-clock scores
against one peak for the whole session, ``NIDT_PEAK_FLOPS`` or the
card's bf16 peak; the journal still makes it resumable). The ``PROFILE_*`` environment sizes the
driver's cells (``obs/probe.py``).

The virtual backend finishes with a determinism self-check — the whole
search re-runs twice in memory and the serialized recipes are
byte-compared — and ``--validate_winner`` additionally runs the winning
cell through the REAL driver once at screen fidelity, so the committed
recipe is proven loadable and runnable, not just well-scored. The last
stdout line is the machine-readable session summary (the CLI contract
shared with the trainer CLI).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from neuroimagedisttraining_tpu_torch.tune import recipe as tune_recipe
from neuroimagedisttraining_tpu_torch.tune import search as tune_search
from neuroimagedisttraining_tpu_torch.tune import space as tune_space


def add_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--backend", type=str, default="virtual",
                    choices=("virtual", "driver"),
                    help="measurement backend: the seeded deterministic "
                         "cost model | the real engine.train() probe "
                         "driver")
    ap.add_argument("--seed", type=int, default=20,
                    help="search seed (virtual scores + tie-breaks are "
                         "derived from it; same seed + space = same "
                         "recipe bytes)")
    ap.add_argument("--out", type=str, default="",
                    help="recipe output path (default: the package's "
                         "recipes/<device_kind>.json)")
    ap.add_argument("--session_out", type=str, default="",
                    help="session-artifact output path; empty = don't "
                         "write")
    ap.add_argument("--journal", type=str, default="",
                    help="JSONL measurement journal for kill/resume; "
                         "empty = in-memory only")
    ap.add_argument("--screen_rounds", type=int, default=2,
                    help="short-window screen fidelity (rounds)")
    ap.add_argument("--commit_rounds", type=int, default=5,
                    help="committed-window fidelity survivors are "
                         "re-measured at")
    ap.add_argument("--survivors", type=int, default=4,
                    help="screen survivors re-measured at the committed "
                         "window")
    ap.add_argument("--virtual_devices", type=int, default=0,
                    help="a mesh of N entries on the device (client_mesh "
                         "cells need >= 2; the trainer CLI's mechanism)")
    ap.add_argument("--device_kind", type=str, default="",
                    help="override the recipe's device kind (default: "
                         "the device's: the card's name, or cpu)")
    ap.add_argument("--n_devices", type=int, default=0,
                    help="override the mesh entries the space's validity "
                         "predicates use (default: the device's)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu: where the driver backend "
                         "and --validate_winner run")
    ap.add_argument("--validate_winner", action="store_true",
                    help="after emission, run the winning cell once "
                         "through the REAL probe driver at screen "
                         "fidelity (proves the recipe is runnable, not "
                         "just well-scored)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m neuroimagedisttraining_tpu_torch.tune",
        description=__doc__.split("\n\n")[0])
    add_args(ap)
    args = ap.parse_args(argv)

    import torch

    from neuroimagedisttraining_tpu_torch.device import resolve_device
    from neuroimagedisttraining_tpu_torch.obs import probe as obs_probe

    dev = resolve_device(args.device)
    device_kind = args.device_kind or tune_recipe._live_device_kind(dev)
    n_devices = args.n_devices or len(obs_probe.mesh_entries(
        dev, args.virtual_devices))

    space = tune_space.build_space(device_kind, n_devices)
    journal = tune_search.Journal(args.journal) if args.journal else None
    peak = None
    if args.backend == "virtual":
        measure = tune_search.virtual_measure
    else:
        measure = tune_search.make_driver_measure(
            device=dev, virtual_devices=args.virtual_devices)
        peak = measure.peak_flops

    t0 = time.time()
    try:
        res = tune_search.run_search(
            space, args.seed, measure, journal,
            screen_fidelity=args.screen_rounds,
            commit_fidelity=args.commit_rounds,
            survivors=args.survivors)
    except ValueError as e:
        ap.error(str(e))
    doc = tune_recipe.recipe_doc_from_search(res, device_kind)

    # determinism self-check (virtual backend only): the WHOLE search
    # twice more, in memory, byte-comparing the serialized recipes.
    # The driver backend measures wall clocks — determinism is not its
    # contract, so the check reads null there, not green.
    deterministic = None
    if args.backend == "virtual":
        reruns = []
        for _ in range(2):
            r = tune_search.run_search(
                space, args.seed, measure, None,
                screen_fidelity=args.screen_rounds,
                commit_fidelity=args.commit_rounds,
                survivors=args.survivors, log=lambda *a: None)
            d = tune_recipe.recipe_doc_from_search(r, device_kind)
            reruns.append(json.dumps(d, sort_keys=True))
        want = json.dumps(doc, sort_keys=True)
        deterministic = all(r == want for r in reruns)

    out = args.out or os.path.join(
        tune_recipe.recipes_dir(),
        tune_recipe.device_slug(device_kind) + ".json")
    tune_recipe.write_recipe(doc, out)
    print(f"[tune] recipe -> {out} (sha256 {doc['sha256'][:12]}…)",
          file=sys.stderr)

    validation = {"ran": False}
    if args.validate_winner:
        # prove the committed winner survives the full load path + the
        # real driver: load (sha/domain/kind checks) then one short
        # probe window through engine.train()
        loaded = tune_recipe.load_recipe(out, expected_kind=device_kind)
        driver = (measure if args.backend == "driver"
                  else tune_search.make_driver_measure(
                      device=dev, virtual_devices=args.virtual_devices))
        m = driver(loaded["cell"], args.screen_rounds, args.seed)
        validation = {"ran": True, "status": m["status"],
                      "reason": m["reason"],
                      "round_ms": m["metrics"].get("round_ms")}
        print(f"[tune] winner validation: {m['status']}"
              + (f" ({m['reason']})" if m["reason"] else ""),
              file=sys.stderr)

    session = {
        "metric": "autotune_session",
        "meta": {"device_kind": device_kind, "n_devices": n_devices,
                 "seed": args.seed, "backend": args.backend,
                 "screen_rounds": args.screen_rounds,
                 "commit_rounds": args.commit_rounds,
                 "survivors": args.survivors, "peak_flops": peak,
                 "torch": torch.__version__},
        "space": {"n_cells": res["n_cells"],
                  "n_rejected": len(res["rejected"]),
                  "fingerprint": res["space_fingerprint"]},
        "search": {"screened": len(res["screened"]),
                   "refined": len(res["refined"]),
                   "fresh_measurements": res["fresh_measurements"],
                   "journal_reused": res["journal_reused"]},
        "winner": {"fingerprint": doc["fingerprint"],
                   "cell": doc["cell"], "score": doc["score"],
                   "score_metric": doc["score_metric"],
                   "fidelity": doc["fidelity"]},
        "recipe": {"path": out, "sha256": doc["sha256"]},
        "session": {"deterministic": deterministic,
                    "wall_s": round(time.time() - t0, 3)},
        "winner_validation": validation,
    }
    if args.session_out:
        d = os.path.dirname(args.session_out)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.session_out, "w") as f:
            json.dump(session, f, indent=1, sort_keys=True)
            f.write("\n")
    print(json.dumps(session, sort_keys=True))
    ok = (deterministic is not False
          and (not validation["ran"] or validation["status"] == "ok"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
