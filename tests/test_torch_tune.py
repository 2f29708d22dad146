"""The port's autotuner (``neuroimagedisttraining_tpu_torch/tune``) and the
CLI's ``--recipe`` against the reference's ``tune/``.

- **The virtual search is the reference's, byte for byte**: on the same
  space and seed both packages' score traces, winners and recipe bytes
  are equal (the backend derives every score from sha256 of the seed,
  the cell's fingerprint and the fidelity: exact, no tolerance), and the
  committed ``recipes/cpu.json`` regenerates byte for byte. No file
  under ``bench_matrix/`` is read.
- The journal resumes without re-measuring, tolerates a torn tail line,
  and failed cells lose without crashing the search.
- ``apply_recipe`` gives the reference's config for the same argv and
  recipe; an explicit flag wins and is counted as ``recipe-override``.
- Every recipe failure mode is refused with the reference's message (the
  regenerate hint names the port's tuner).
- ``drift_rules`` equal the reference's, fire, and merge with the
  built-ins; the CLI run arms them.
- A ``driver`` session ranks cells of both precisions by throughput
  against one peak; ``--validate_winner`` runs the real driver on
  ``3dcnn_tiny`` at 12x14x12 on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import pytest

from neuroimagedisttraining_tpu.tune import recipe as RR
from neuroimagedisttraining_tpu.tune import search as RS
from neuroimagedisttraining_tpu.tune import space as RSP
from neuroimagedisttraining_tpu_torch.obs import compute as pcompute
from neuroimagedisttraining_tpu_torch.obs import flight as pflight
from neuroimagedisttraining_tpu_torch.obs import metrics as pmetrics
from neuroimagedisttraining_tpu_torch.obs import names as PN
from neuroimagedisttraining_tpu_torch.obs import probe as pprobe
from neuroimagedisttraining_tpu_torch.obs import rules as prules
from neuroimagedisttraining_tpu_torch.tune import recipe as PR
from neuroimagedisttraining_tpu_torch.tune import search as PS
from neuroimagedisttraining_tpu_torch.tune import space as PSP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "neuroimagedisttraining_tpu_torch",
                         "recipes", "cpu.json")
#: the committed CPU recipe's search: seed, screen and commit rounds,
#: survivors, on the CPU space of 2 mesh entries
SEED, SCREEN, COMMIT, SURVIVORS = 20, 2, 5, 4


def _search(lib_space, lib_search, measure=None, journal=None, **kw):
    space = lib_space.build_space("cpu", n_devices=2)
    return lib_search.run_search(
        space, SEED, measure or lib_search.virtual_measure, journal,
        screen_fidelity=SCREEN, commit_fidelity=COMMIT,
        survivors=SURVIVORS, log=lambda *a: None, **kw)


# ---------------------------------------------------------------------------
# space and search: the reference's, exactly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_devices,hbm", [(2, None), (1, None), (2, "tight")])
def test_space_census_equals_the_reference(n_devices, hbm):
    if hbm == "tight":
        hbm = int(RSP.est_step_bytes((12, 14, 12), 16, "fp32", "none")
                  / 0.92) - 1
    assert PSP.est_step_bytes((121, 145, 121), 16, "fp32", "none") == \
        RSP.est_step_bytes((121, 145, 121), 16, "fp32", "none")
    p = PSP.Space(axes=PSP.DEFAULT_AXES, n_devices=n_devices, hbm_bytes=hbm)
    r = RSP.Space(axes=RSP.DEFAULT_AXES, n_devices=n_devices, hbm_bytes=hbm)
    assert p.cells() == r.cells()
    assert p.fingerprint() == r.fingerprint()


def test_space_refusals_and_the_card_row():
    with pytest.raises(ValueError, match="unknown axes.*bogus"):
        PSP.Space(axes=(("bogus", (1, 2)),))
    with pytest.raises(ValueError, match="out of domain"):
        PSP.Space(axes=(("precision", ("fp32", "fp64")),))
    with pytest.raises(ValueError, match="no values"):
        PSP.Space(axes=(("precision", ()),))
    card = PSP.build_space("NVIDIA H100 80GB HBM3", 1, shape=(121, 145, 121))
    assert card.hbm_bytes == 80 * 10 ** 9
    valid, rejected = card.cells()
    # one card: the client_mesh=2 cells go, with their reason; the
    # flagship's largest step estimate is far under 0.92 x 80 GB
    assert len(valid) == 48 and len(rejected) == 48
    assert all("client_mesh=2" in r["reason"] for r in rejected)
    assert PSP.build_space("cpu", 1).hbm_bytes is None


def test_compat_rows_relevant_to_the_space_are_satisfied():
    """The port's matrix carries the two rows the PINNED knobs exist for,
    and every cell of the space composes with the pins under the port's
    own validator."""
    from neuroimagedisttraining_tpu_torch.config import OptimConfig
    from neuroimagedisttraining_tpu_torch.core.optim import (
        validate_precision,
    )

    rows = PSP.relevant_compat_rows()
    assert {r["knobs"] for r in rows} == {
        ("client_optimizer", "fused_update"), ("loss_scale", "precision")}
    valid, _ = PSP.build_space("cpu", 2).cells()
    for cell in valid:
        validate_precision(OptimConfig(
            client_optimizer=PSP.PINNED["client_optimizer"],
            loss_scale=PSP.PINNED["loss_scale"],
            precision=cell["precision"],
            fused_update=cell["fused_update"]))


def test_virtual_search_writes_the_reference_recipe_bytes(tmp_path):
    res = {lib: _search(sp, se) for lib, sp, se in
           (("ref", RSP, RS), ("port", PSP, PS))}
    key = ("fingerprint", "fidelity", "status", "score", "reason")
    for rung in ("screened", "refined"):
        assert [[m[k] for k in key] for m in res["port"][rung]] == \
            [[m[k] for k in key] for m in res["ref"][rung]]
    assert res["port"]["winner"] == res["ref"]["winner"]
    paths = {}
    for lib, mod in (("ref", RR), ("port", PR)):
        paths[lib] = tmp_path / f"{lib}.json"
        mod.write_recipe(mod.recipe_doc_from_search(res[lib], "cpu"),
                         str(paths[lib]))
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()
    # the committed CPU recipe is this search's output
    assert paths["port"].read_bytes() == open(COMMITTED, "rb").read()


def test_search_failed_cells_lose_not_crash():
    def flaky(cell, fidelity, seed):
        if cell["precision"] == "bf16_mixed":
            return {"status": "failed", "reason": "recompile-storm",
                    "score": None, "score_metric": "none", "metrics": {}}
        return PS.virtual_measure(cell, fidelity, seed)

    res = _search(PSP, PS, flaky)
    assert res["winner"]["cell"]["precision"] == "fp32"
    failed = [m for m in res["screened"] if m["status"] == "failed"]
    assert len(failed) == 48
    with pytest.raises(ValueError, match="every screened cell failed"):
        _search(PSP, PS, lambda c, f, s: {
            "status": "failed", "reason": "x", "score": None,
            "score_metric": "none", "metrics": {}})


def test_journal_resume_and_torn_tail(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    calls = {"n": 0}

    def counting(cell, fidelity, seed):
        calls["n"] += 1
        return PS.virtual_measure(cell, fidelity, seed)

    res = _search(PSP, PS, counting, PS.Journal(path))
    assert res["fresh_measurements"] == calls["n"] == 100
    lines = open(path).read().splitlines(keepends=True)
    with open(path, "w") as f:  # killed mid-screen, mid-write
        f.writelines(lines[:40])
        f.write('{"fingerprint": "torn')
    calls["n"] = 0
    res2 = _search(PSP, PS, counting, PS.Journal(path))
    assert calls["n"] == 60 and res2["journal_reused"] == 40
    assert res2["winner"] == res["winner"]
    calls["n"] = 0
    res3 = _search(PSP, PS, counting, PS.Journal(path))
    assert calls["n"] == 0 and res3["journal_reused"] == 100
    assert res3["winner"] == res["winner"]


# ---------------------------------------------------------------------------
# recipes: load, apply, refuse
# ---------------------------------------------------------------------------


def _parse(mod, argv):
    parser = argparse.ArgumentParser()
    mod.add_args(parser)
    return parser.parse_args(argv)


def _fallbacks(registry) -> float:
    snap = registry.snapshot()
    return sum(v["value"] for v in
               snap.get("nidt_fallback_total", {}).get("values", ())
               if v["labels"].get("reason") == "recipe-override")


@pytest.mark.parametrize("argv", [[], ["--batch_size", "4"],
                                  ["--precision=fp32", "--remat", "stem"]])
def test_apply_recipe_equals_the_reference(argv, capsys):
    from neuroimagedisttraining_tpu import __main__ as RM
    from neuroimagedisttraining_tpu.obs import metrics as rmetrics
    from neuroimagedisttraining_tpu_torch import __main__ as PM

    got = {}
    for lib, main, rec, reg in (("ref", RM, RR, rmetrics.REGISTRY),
                                ("port", PM, PR, pmetrics.REGISTRY)):
        doc = rec.load_recipe(COMMITTED, expected_kind="cpu")
        args = _parse(main, argv)
        before = _fallbacks(reg)
        overridden = rec.apply_recipe(args, doc, argv)
        cfg = main.config_from_args(args)
        got[lib] = {
            "overridden": overridden,
            "counted": _fallbacks(reg) - before,
            "cfg": (cfg.optim.precision, cfg.optim.fused_update, cfg.remat,
                    cfg.fed.client_mesh, cfg.fed.rounds_per_dispatch,
                    cfg.optim.batch_size),
            "score": reg.snapshot()["nidt_recipe_score"]["values"][0][
                "value"],
            "stderr": capsys.readouterr().err.count("[recipe]")}
    assert got["port"] == got["ref"]
    assert got["port"]["counted"] == len(got["port"]["overridden"])
    if not argv:
        cell = json.load(open(COMMITTED))["cell"]
        assert got["port"]["cfg"] == (
            cell["precision"], cell["fused_update"], cell["remat"],
            cell["client_mesh"], cell["rounds_per_dispatch"], cell["batch"])


def _mutated(tmp_path, name, mutate):
    doc = json.load(open(COMMITTED))
    mutate(doc)
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return str(path)


def _repin(doc):
    doc["sha256"] = PR.recipe_sha(doc)


def _with_cell(**kw):
    def mutate(doc):
        doc["cell"] = dict(doc["cell"], **kw)
        doc["fingerprint"] = PSP.cell_fingerprint(doc["cell"])
        _repin(doc)
    return mutate


FAILURES = {
    "unreadable": None,
    "truncated": None,
    "not_an_object": None,
    "missing_keys": lambda d: d.pop("score"),
    "sha_mismatch": lambda d: d.__setitem__("score", 99.0),
    "empty_cell": lambda d: (d.__setitem__("cell", {}), _repin(d)),
    "unknown_key": _with_cell(loss_scale=2.0),
    "out_of_domain": _with_cell(precision="fp64"),
    "hand_edited_cell": lambda d: (d["cell"].__setitem__("batch", 8),
                                   _repin(d)),
    "wrong_kind": lambda d: (d.__setitem__("device_kind", "TPU v4"),
                             _repin(d)),
}


@pytest.mark.parametrize("mode", sorted(FAILURES))
def test_recipe_failure_modes_refused_with_the_reference_messages(
        tmp_path, mode):
    if mode == "unreadable":
        path = str(tmp_path / "absent.json")
    elif mode == "truncated":
        path = str(tmp_path / "t.json")
        open(path, "w").write(open(COMMITTED).read()[:40])
    elif mode == "not_an_object":
        path = str(tmp_path / "l.json")
        open(path, "w").write("[1, 2]")
    else:
        path = _mutated(tmp_path, "r.json", FAILURES[mode])
    msgs = []
    for rec in (RR, PR):
        with pytest.raises(ValueError) as e:
            rec.load_recipe(path, expected_kind="cpu")
        msgs.append(str(e.value))
    assert msgs[1].replace(PR.RETUNE, "scripts/run_autotune.sh") == msgs[0]


def test_auto_resolves_the_device_kind_and_refuses_a_missing_recipe(
        tmp_path, monkeypatch):
    doc = PR.resolve_and_load("auto", "cpu")
    assert doc["_path"] == os.path.join(PR.recipes_dir(), "cpu.json")
    assert os.path.samefile(doc["_path"], COMMITTED)
    msgs = []
    for rec in (RR, PR):
        monkeypatch.setattr(rec, "recipes_dir",
                            lambda: str(tmp_path / "none"))
        with pytest.raises(ValueError) as e:
            if rec is PR:
                rec.resolve_and_load("auto", "cpu")
            else:
                rec.resolve_and_load("auto")
        msgs.append(str(e.value))
    assert msgs[1].replace(PR.RETUNE, "scripts/run_autotune.sh") == msgs[0]
    assert PR.device_slug("NVIDIA H100 80GB HBM3") == "nvidia_h100_80gb_hbm3"


def test_recipe_keys_are_the_reference_table_and_the_cell_keys():
    assert PR.RECIPE_KEYS == RR.RECIPE_KEYS
    assert set(PR.RECIPE_KEYS) == set(pprobe.CELL_KEYS)


# ---------------------------------------------------------------------------
# the drift loop
# ---------------------------------------------------------------------------


def _snap(metric, value):
    return {metric: {"kind": "gauge", "help": "",
                     "values": [{"labels": {}, "value": value}]}}


@pytest.mark.parametrize("score_metric", ["sustained_tflops", "mfu"])
def test_drift_rule_equals_the_reference_and_fires(score_metric):
    doc = dict(json.load(open(COMMITTED)), score_metric=score_metric)
    (rule,) = PR.drift_rules(doc)
    (ref,) = RR.drift_rules(doc)
    for field in ("name", "metric", "op", "threshold", "severity",
                  "for_rounds", "on_fire_event"):
        assert getattr(rule, field) == getattr(ref, field), field
    assert rule.metric == (PN.MFU if score_metric == "mfu"
                           else PN.SUSTAINED_TFLOPS)
    pflight.clear()
    eng = prules.RuleEngine([rule])
    for r in range(rule.for_rounds):
        eng.observe(r, _snap(rule.metric, 0.5 * doc["score"]))
    assert eng.health_block()["firing"] == {"mfu-below-recipe": "warn"}
    ev = [e for e in pflight.events() if e["kind"] == "retune_recommended"]
    assert ev and ev[0]["rule"] == "mfu-below-recipe"
    pflight.clear()
    eng2 = prules.RuleEngine([rule])
    for r in range(4):
        eng2.observe(r, _snap(rule.metric, doc["score"]))
    assert eng2.health_block()["firing"] == {}
    assert not [e for e in pflight.events()
                if e["kind"] == "retune_recommended"]
    assert PR.drift_rules(dict(doc, score=None)) == ()


def test_configure_merges_drift_rules_with_the_builtins():
    doc = json.load(open(COMMITTED))
    eng = prules.configure(extra_rules=PR.drift_rules(doc))
    try:
        names = {r.name for r in eng.rules}
        assert "mfu-below-recipe" in names and "mfu-floor" in names
        assert len(names) == len(prules.builtin_rules()) + 1
    finally:
        prules.disarm()


# ---------------------------------------------------------------------------
# the CLI's --recipe
# ---------------------------------------------------------------------------


def test_cli_recipe_applies_overrides_and_refuses(tmp_path, capsys):
    from neuroimagedisttraining_tpu_torch import __main__ as PM

    before = _fallbacks(pmetrics.REGISTRY)
    args, cfg, doc = PM.parse(["--device", "cpu", "--recipe", "auto",
                               "--batch_size", "4"])
    cell = doc["cell"]
    assert cfg.recipe == "auto" and cfg.optim.batch_size == 4
    assert (cfg.optim.precision, cfg.optim.fused_update, cfg.remat,
            cfg.fed.client_mesh, cfg.fed.rounds_per_dispatch) == (
        cell["precision"], cell["fused_update"], cell["remat"],
        cell["client_mesh"], cell["rounds_per_dispatch"])
    assert _fallbacks(pmetrics.REGISTRY) == before + 1
    capsys.readouterr()
    bad = tmp_path / "bad.json"
    bad.write_text('{"cell": {')
    with pytest.raises(SystemExit) as e:
        PM.parse(["--device", "cpu", "--recipe", str(bad)])
    assert e.value.code == 2
    assert "--recipe: recipe" in capsys.readouterr().err
    # a recipe knob that conflicts with a spelled flag dies at argparse
    with pytest.raises(SystemExit):
        PM.parse(["--device", "cpu", "--recipe", "auto",
                  "--client_optimizer", "adam"])
    assert "fused_update" in capsys.readouterr().err


def test_cli_run_arms_the_drift_rule(tmp_path, capsys):
    """A run of the tiny model under ``--recipe auto`` (the committed CPU
    recipe: bf16_mixed, the fused update, 2 mesh entries, K = 4) ends ok
    with ``mfu-below-recipe`` among its rules."""
    from neuroimagedisttraining_tpu_torch import __main__ as PM

    from torch_port_support import torch_threads

    with torch_threads(2):
        code = PM.main([
            "--device", "cpu", "--dataset", "synthetic", "--model",
            "3dcnn_tiny", "--synthetic_shape", "12", "14", "12",
            "--synthetic_num_subjects", "32", "--client_num_in_total", "4",
            "--comm_round", "2", "--batch_size", "4", "--virtual_devices",
            "2", "--recipe", "auto", "--log_dir", str(tmp_path)])
    assert code == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    verdict = json.load(open(result["health_verdict_path"]))
    rule = next(r for r in verdict["rules"]
                if r["name"] == "mfu-below-recipe")
    assert rule["metric"] == PN.SUSTAINED_TFLOPS
    assert result["health"]["status"] == "ok"


# ---------------------------------------------------------------------------
# the driver backend
# ---------------------------------------------------------------------------


H100 = "NVIDIA H100 80GB HBM3"
#: a stand-in card's sustained TFLOP/s by cell: bf16 faster than fp32, the
#: fused update a little faster than the plain chain
TFLOPS = {("fp32", False): 10.0, ("fp32", True): 10.2,
          ("bf16_mixed", False): 12.0, ("bf16_mixed", True): 12.5}


@pytest.mark.parametrize("one_peak", [True, False])
def test_driver_session_ranks_both_precisions_by_throughput(
        monkeypatch, one_peak):
    """A stub ``run_probe`` stands in for the card: it arms the profiler
    as an engine does (the peak of the cell's precision on an H100,
    unless the session's one peak, here ``NIDT_PEAK_FLOPS``, overrides
    it) and reports MFU against that peak. With the session's one peak
    the driver's ranking is the throughput's; with per-precision peaks
    (the CPU's session has none of its own) an fp32 cell would win."""
    def fake_probe(probe, meta, fed, device, entries=None):
        cell = probe.cell
        with monkeypatch.context() as m:  # the engine's arm: the table's
            m.delenv("NIDT_PEAK_FLOPS", raising=False)  # peak of its card
            pcompute.arm_model("fedavg", 1.0, precision=cell["precision"],
                               device_name=H100)
        tflops = TFLOPS[cell["precision"], cell["fused_update"]]
        peak = pcompute.PROFILER.health()["peak_flops"]
        return {"config": dict(cell), "ran": True, "mfu": tflops * 1e12 /
                peak, "sustained_tflops": tflops, "round_ms": 1.0,
                "dispatches": 2, "compiles": 1, "step_replays": 3,
                "launches": {}}

    monkeypatch.setattr(pprobe, "run_probe", fake_probe)
    monkeypatch.setattr(pprobe, "_make_fed", lambda meta, device: None)
    if one_peak:
        monkeypatch.setenv("NIDT_PEAK_FLOPS", "989.4e12")
    else:
        monkeypatch.delenv("NIDT_PEAK_FLOPS", raising=False)
    pcompute.PROFILER.reset()
    try:
        measure = PS.make_driver_measure(device="cpu")
        assert measure.peak_flops == (989.4e12 if one_peak else None)
        space = PSP.Space(axes=(("precision", ("fp32", "bf16_mixed")),
                                ("fused_update", (False, True))))
        res = PS.run_search(space, SEED, measure, screen_fidelity=1,
                            commit_fidelity=1, survivors=2,
                            log=lambda *a: None)
    finally:
        pcompute.PROFILER.reset()
    ranked = sorted(res["screened"], key=lambda m: -m["score"])
    by_throughput = sorted(res["screened"], key=lambda m: -TFLOPS[
        m["cell"]["precision"], m["cell"]["fused_update"]])
    assert all(m["score_metric"] == "mfu" for m in ranked)
    if one_peak:
        assert ranked == by_throughput
        assert res["winner"]["cell"] == {"precision": "bf16_mixed",
                                         "fused_update": True}
    else:
        assert res["winner"]["cell"]["precision"] == "fp32"


def test_validate_winner_through_the_real_driver(tmp_path, capsys):
    """The tuner's CLI: the virtual search, then the winner (bf16_mixed,
    the fused update, 2 mesh entries, K = 4, batch 16) once through the
    real probe driver on ``3dcnn_tiny`` at 12x14x12 on the CPU."""
    from neuroimagedisttraining_tpu_torch.tune.__main__ import main

    from torch_port_support import torch_threads

    with torch_threads(2):
        code = main(["--backend", "virtual", "--device", "cpu",
                     "--virtual_devices", "2", "--out",
                     str(tmp_path / "cpu.json"), "--journal",
                     str(tmp_path / "j.jsonl"), "--validate_winner"])
    session = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0
    assert session["session"]["deterministic"] is True
    assert session["winner_validation"]["ran"] is True
    assert session["winner_validation"]["status"] == "ok"
    assert (tmp_path / "cpu.json").read_bytes() == open(COMMITTED,
                                                        "rb").read()
