"""Per-hardware recipes: the autotuner's winner as a config artifact
(the reference package's ``tune/recipe.py``).

A recipe is the committed serialization of one search winner —
``neuroimagedisttraining_tpu_torch/recipes/<device_kind>.json`` —
carrying the winning cell, its committed-window score, the full score
trace of both fidelity rungs, the space fingerprint it was searched
under, and a sha256 self-pin over the whole document (a truncated or
hand-edited recipe fails loudly at load, never silently mis-tunes a
run).

``--recipe <path|auto>`` on the CLI loads one as config DEFAULTS: every
knob the operator did not spell on the command line is set from the
recipe; a knob the operator DID spell wins, and the override is
announced through the structured fallback machinery
(``engines/program.py`` REASONS key ``recipe-override``) so the
divergence is scrapeable, not silent. Loading also publishes the
recipe's score as ``nidt_recipe_score`` and arms the
``mfu-below-recipe`` drift rule (:func:`drift_rules`): when the live
score metric sits below 80% of the recipe's recorded score for 3
boundaries, ``nidt_alert`` fires and a ``retune_recommended`` event
lands in the flight recorder — the closed loop's "re-tune now" signal.

Every key a recipe may set is declared in :data:`RECIPE_KEYS`
(cell knob -> CLI option); the ``recipe-key-closure`` project lint
rule checks the committed recipes stay inside this table and that the
table's options exist on the CLI.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import sys

from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
from neuroimagedisttraining_tpu_torch.obs import names as obs_names
from neuroimagedisttraining_tpu_torch.obs import probe as obs_probe
from neuroimagedisttraining_tpu_torch.tune.space import cell_fingerprint

__all__ = ["RECIPE_KEYS", "apply_recipe", "drift_rules", "load_recipe",
           "resolve_and_load", "recipe_doc_from_search", "recipe_sha",
           "write_recipe", "recipes_dir", "device_slug"]

#: every knob a recipe may set, mapped to the CLI option that owns it
#: (the ``recipe-key-closure`` lint rule pins this table against the
#: committed recipes and the argparse surface). A cell
#: key outside this table is a load-time error — a recipe can never
#: name a config field the CLIs do not declare.
RECIPE_KEYS = {
    "precision": "--precision",
    "fused_update": "--fused_update",
    "remat": "--remat",
    "client_mesh": "--client_mesh",
    "rounds_per_dispatch": "--rounds_per_dispatch",
    "batch": "--batch_size",
}

#: live-score-to-recipe-score ratio below which the drift rule fires
DRIFT_RATIO = 0.8
#: boundaries the ratio must hold before the drift rule fires
DRIFT_ROUNDS = 3

#: how a recipe is made anew (the refusals' hint)
RETUNE = "python -m neuroimagedisttraining_tpu_torch.tune"


def device_slug(device_kind: str) -> str:
    """``"NVIDIA H100 80GB HBM3"`` -> ``"nvidia_h100_80gb_hbm3"`` — the
    recipe file stem."""
    return device_kind.strip().lower().replace(" ", "_")


def recipes_dir() -> str:
    """The committed recipes: ``<package>/recipes``."""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "recipes")


def recipe_sha(doc: dict) -> str:
    """sha256 over the canonical JSON of the document MINUS its own
    ``sha256`` field — the self-pin."""
    body = {k: v for k, v in doc.items() if k != "sha256"}
    canon = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()


def recipe_doc_from_search(result: dict, device_kind: str) -> dict:
    """The committed recipe document for one ``run_search`` result:
    winner + score trace of both rungs + the space identity, sha-pinned.
    Key order is irrelevant (serialization sorts); the trace keeps only
    the ranking-relevant fields so recipe bytes stay stable."""
    def _trace(rows):
        return [{"fingerprint": m["fingerprint"], "fidelity": m["fidelity"],
                 "status": m["status"], "score": m["score"],
                 "reason": m["reason"]} for m in rows]

    w = result["winner"]
    doc = {
        "metric": "autotune_recipe",
        "device_kind": device_kind,
        "cell": dict(w["cell"]),
        "fingerprint": w["fingerprint"],
        "score": w["score"],
        "score_metric": w["score_metric"],
        "fidelity": w["fidelity"],
        "seed": result["seed"],
        "space_fingerprint": result["space_fingerprint"],
        "trace": {"screened": _trace(result["screened"]),
                  "refined": _trace(result["refined"]),
                  "rejected": result["rejected"]},
    }
    doc["sha256"] = recipe_sha(doc)
    return doc


def write_recipe(doc: dict, path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def load_recipe(path: str, expected_kind: str | None = None) -> dict:
    """Load + fully validate one recipe file. Every failure mode is a
    ``ValueError`` naming the file and the defect — the CLIs surface it
    through ``parser.error`` so a bad recipe dies loudly at startup."""
    try:
        with open(path) as f:
            raw = f.read()
    except OSError as e:
        raise ValueError(f"recipe {path}: cannot read ({e})") from e
    try:
        doc = json.loads(raw)
    except ValueError as e:
        raise ValueError(
            f"recipe {path}: invalid JSON ({e}) — truncated or "
            f"corrupt; regenerate with {RETUNE}") from e
    if not isinstance(doc, dict):
        raise ValueError(f"recipe {path}: expected a JSON object, got "
                         f"{type(doc).__name__}")
    missing = [k for k in ("device_kind", "cell", "fingerprint",
                           "score", "score_metric", "sha256")
               if k not in doc]
    if missing:
        raise ValueError(f"recipe {path}: missing keys {missing}")
    want = recipe_sha(doc)
    if doc["sha256"] != want:
        raise ValueError(
            f"recipe {path}: sha256 mismatch (recorded "
            f"{doc['sha256'][:12]}…, computed {want[:12]}…) — the file "
            "was edited or truncated after emission; re-run the tuner")
    cell = doc["cell"]
    if not isinstance(cell, dict) or not cell:
        raise ValueError(f"recipe {path}: 'cell' must be a non-empty "
                         "object of knob -> value")
    for key, value in sorted(cell.items()):
        if key not in RECIPE_KEYS:
            raise ValueError(
                f"recipe {path}: cell key {key!r} has no config-field "
                f"mapping; a recipe may only set "
                f"{sorted(RECIPE_KEYS)} (tune/recipe.py RECIPE_KEYS)")
        try:
            obs_probe.validate_cell_value(key, value)
        except ValueError as e:
            raise ValueError(f"recipe {path}: {e}") from e
    if cell_fingerprint(cell) != doc["fingerprint"]:
        raise ValueError(
            f"recipe {path}: winner fingerprint does not match the "
            "cell — the file was hand-edited; re-run the tuner")
    if expected_kind is not None and doc["device_kind"] != expected_kind:
        raise ValueError(
            f"recipe {path}: tuned for device_kind "
            f"{doc['device_kind']!r} but this process runs on "
            f"{expected_kind!r}; pass the matching recipe or re-tune "
            f"({RETUNE})")
    doc["_path"] = path
    return doc


def _live_device_kind(device="cuda") -> str:
    """The device kind a run on ``device`` has: the card's name
    (``torch.cuda.get_device_name``), or ``"cpu"``."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(dev)


def resolve_and_load(arg: str, device="cuda") -> dict:
    """``--recipe`` resolution for a run on ``device``: a literal path
    loads that file (its device_kind must match the run's device);
    ``auto`` looks up the committed recipe for the device kind under
    :func:`recipes_dir`."""
    kind = _live_device_kind(device)
    if arg == "auto":
        path = os.path.join(recipes_dir(), device_slug(kind) + ".json")
        if not os.path.exists(path):
            have = sorted(os.path.basename(p) for p in
                          glob.glob(os.path.join(recipes_dir(), "*.json")))
            raise ValueError(
                f"no committed recipe for device_kind {kind!r} "
                f"(looked for {path}); committed recipes: "
                f"{have or 'none'} — run {RETUNE}")
    else:
        path = arg
    return load_recipe(path, expected_kind=kind)


def apply_recipe(args, doc: dict, argv: list[str]) -> list[str]:
    """Apply a loaded recipe to the parsed-args namespace as config
    DEFAULTS: each recipe knob whose CLI option the operator did NOT
    spell in ``argv`` is set from the recipe; an explicitly-spelled
    option keeps its CLI value and the divergence is announced through
    the structured fallback counter (REASONS key ``recipe-override``).
    Returns the cell keys that were overridden (kept CLI values)."""
    from neuroimagedisttraining_tpu_torch.engines.program import (
        report_fallback,
    )

    overridden: list[str] = []
    for key in sorted(doc["cell"]):
        opt = RECIPE_KEYS[key]
        dest = "batch_size" if key == "batch" else opt.lstrip("-")
        value = doc["cell"][key]
        explicit = any(tok == opt or tok.startswith(opt + "=")
                       for tok in argv)
        if explicit:
            overridden.append(key)
            msg = report_fallback("cli", "recipe-override",
                                  "[recipe] %s kept over the recipe's %r",
                                  opt, value)
            print(f"[recipe] {opt} spelled on the command line; keeping "
                  f"the CLI value over the recipe's {value!r} — {msg}",
                  file=sys.stderr)
            continue
        if key == "fused_update":
            value = bool(value)
        elif key == "remat" and isinstance(value, bool):
            value = "all" if value else "none"
        setattr(args, dest, value)
    obs_metrics.gauge(
        obs_names.RECIPE_SCORE,
        "the loaded autotuner recipe's recorded committed-window score "
        "(tune/recipe.py) — the mfu-below-recipe drift rule compares "
        "the live score metric against 80% of this",
    ).set(float(doc["score"]))
    return overridden


def drift_rules(doc: dict) -> tuple:
    """The closed loop's re-tune trigger: one HealthRule that fires
    when the live score metric sits below ``DRIFT_RATIO`` of the
    recipe's recorded score for ``DRIFT_ROUNDS`` boundaries. Firing
    raises ``nidt_alert{rule="mfu-below-recipe"}`` and records a
    ``retune_recommended`` flight event (obs/rules.py
    ``on_fire_event``) — the operator's cue to re-run the tuner
    (:data:`RETUNE`)."""
    from neuroimagedisttraining_tpu_torch.obs.rules import HealthRule

    score = doc.get("score")
    if score is None:
        return ()
    metric = (obs_names.MFU if doc.get("score_metric") == "mfu"
              else obs_names.SUSTAINED_TFLOPS)
    return (HealthRule(
        name="mfu-below-recipe",
        metric=metric,
        op="<",
        threshold=DRIFT_RATIO * float(score),
        severity="warn",
        for_rounds=DRIFT_ROUNDS,
        description=(
            "live {} below {:.0%} of the loaded recipe's committed "
            "score {} — hardware/config drift; re-tune "
            "({})".format(metric, DRIFT_RATIO, score, RETUNE)),
        on_fire_event="retune_recommended",
    ),)
