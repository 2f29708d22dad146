"""The port's profile session (``obs/probe.py``) and run report
(``analysis/run_report.py``) against the reference package's.

- Manifest validation: the same cells are accepted and refused, with the
  same messages; ``default_manifest(n)`` and ``load_manifest`` agree.
- A 2-probe session (``fp32_baseline``, ``fused_dispatch_k4``) of each
  package on ``3dcnn_tiny`` at the default 12x14x12, both federations made
  from the same numpy arrays: the same round and window dispatches a
  probe, the reference's artifact keys (``device_kind`` and ``jax`` named
  ``device_name`` and ``torch``), and the port's session passes
  ``session_ok`` through the CLI's ``--profile_session`` with its live
  scrape. The reference's session is run once for the module.
- The run report: a ``3dcnn_tiny`` CLI run of the port writes its metrics
  JSONL, flight dump and verdict; both packages' ``build_report``,
  ``render_markdown`` and CLI give equal output on those files, and the
  report's rounds are the run's.
"""

import json
import logging

import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.analysis import run_report as JR
from neuroimagedisttraining_tpu.obs import probe as JP
from neuroimagedisttraining_tpu_torch.analysis import run_report as PR
from neuroimagedisttraining_tpu_torch.obs import probe as PP

from torch_port_support import torch_threads

MANIFEST = [{"name": "fp32_baseline", "cell": {"precision": "fp32"}},
            {"name": "fused_dispatch_k4",
             "cell": {"precision": "fp32", "rounds_per_dispatch": 4}}]
PROFILE_ENV = ("PROFILE_MODEL", "PROFILE_SHAPE", "PROFILE_BATCH",
               "PROFILE_LOCAL", "PROFILE_CLIENTS", "PROFILE_ROUNDS")


@pytest.fixture(autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def _numpy_fed(meta: dict):
    """The session's federation as numpy arrays, from a seeded generator."""
    rng = np.random.default_rng(20)
    C, n = meta["clients"], meta["n_local"]
    X = rng.integers(0, 255, (C, n) + tuple(meta["shape"]), dtype=np.uint8)
    y = rng.integers(0, 2, (C, n)).astype(np.int32)
    return X, y


def _session(mod, out, monkeypatch, run):
    """``run()`` of ``mod``'s session with its ``_make_fed`` giving the
    numpy federation; returns the artifact."""
    for k in PROFILE_ENV:
        monkeypatch.delenv(k, raising=False)
    orig = mod._make_fed

    def numpy_fed(meta, *device):
        X, y = _numpy_fed(meta)
        fed = orig(meta, *device)
        if mod is PP:
            fed.X_train = torch.from_numpy(X)
            fed.y_train = torch.from_numpy(y)
        else:
            import jax.numpy as jnp

            fed = type(fed)(X_train=jnp.asarray(X), y_train=jnp.asarray(y),
                            n_train=fed.n_train, X_test=jnp.asarray(X[:, :4]),
                            y_test=jnp.asarray(y[:, :4]),
                            n_test=fed.n_test)
            return fed
        fed.X_test, fed.y_test = fed.X_train[:, :4], fed.y_train[:, :4]
        return fed

    monkeypatch.setattr(mod, "_make_fed", numpy_fed)
    run()
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def reference_session(tmp_path_factory):
    """The reference's 2-probe session, once for the module."""
    mp = pytest.MonkeyPatch()
    out = tmp_path_factory.mktemp("ref") / "session.json"
    try:
        manifest = tuple(JP.Probe(p["name"], p["cell"]) for p in MANIFEST)
        yield _session(JP, out, mp,
                       lambda: JP.run_session(manifest, str(out)))
    finally:
        mp.undo()


# ------------------------------------------------------------ manifests

CELLS = [
    {"precision": "fp32"}, {"precision": "bf16_mixed"},
    {"precision": "fp16"}, {"precision": 1},
    {"fused_update": True}, {"fused_update": 1},
    {"remat": True}, {"remat": "stem"}, {"remat": "none"},
    {"remat": "all"}, {"remat": "full"}, {"remat": 0},
    {"client_mesh": 0}, {"client_mesh": 4}, {"client_mesh": -1},
    {"client_mesh": True}, {"client_mesh": 2.0},
    {"rounds_per_dispatch": 1}, {"rounds_per_dispatch": 0},
    {"rounds_per_dispatch": False}, {"batch": 16}, {"batch": 0},
    {"batch": "8"}, {"batchsize": 8}, {"precision": "fp32", "lr": 0.1},
    {},
]


def _verdict(mod, cell):
    try:
        mod.Probe("p", dict(cell))
        return "ok"
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("cell", CELLS, ids=[json.dumps(c) for c in CELLS])
def test_probe_validation_matches_the_reference(cell):
    assert _verdict(PP, cell) == _verdict(JP, cell)


def test_cell_domains_and_default_manifests_match(monkeypatch):
    assert PP.CELL_KEYS == JP.CELL_KEYS
    assert PP.REMAT_CELL_VALUES == JP.REMAT_CELL_VALUES
    for v in (True, False, "none", "stem", "all"):
        assert PP.remat_policy(v) == JP.remat_policy(v)
    for n in (1, 2):
        assert [(p.name, p.cell) for p in PP.default_manifest(n)] == \
            [(p.name, p.cell) for p in JP.default_manifest(n)]
    for k in PROFILE_ENV:
        monkeypatch.delenv(k, raising=False)
    assert PP._env_meta() == JP._env_meta()
    monkeypatch.setenv("PROFILE_SHAPE", "121,145,121")
    monkeypatch.setenv("PROFILE_BATCH", "16")
    assert PP._env_meta() == JP._env_meta()


@pytest.mark.parametrize("doc", [MANIFEST, [], {"name": "x"},
                                 [{"name": "x", "cell": {"remat": "y"}}]],
                         ids=["good", "empty", "not-a-list", "bad-cell"])
def test_load_manifest_matches(tmp_path, doc):
    path = tmp_path / "m.json"
    path.write_text(json.dumps(doc))
    got = []
    for mod in (PP, JP):
        try:
            got.append([(p.name, p.cell)
                        for p in mod.load_manifest(str(path))])
        except ValueError as e:
            got.append(str(e))
    assert got[0] == got[1]


# ------------------------------------------------------------ sessions


def test_session_matches_the_reference(reference_session, tmp_path,
                                       monkeypatch, caplog):
    """The port's session through the CLI (``--device cpu``, a 2-probe
    ``--profile_manifest``, ``--compile_cache`` taken and logged):
    ``session_ok`` with the live scrape, exit 0, each probe's round and
    window dispatches the reference's, and the reference's keys."""
    from neuroimagedisttraining_tpu_torch import __main__ as PM

    man = tmp_path / "manifest.json"
    man.write_text(json.dumps(MANIFEST))
    out = tmp_path / "session.json"
    code = []
    with caplog.at_level(logging.INFO):
        doc = _session(PP, out, monkeypatch, lambda: code.append(PM.main([
            "--device", "cpu", "--profile_session", str(out),
            "--profile_manifest", str(man), "--compile_cache", "/nowhere"])))
    assert "no XLA compile cache" in caplog.text
    ref = reference_session
    assert code == [0] and PP.session_ok(doc) and JP.session_ok(ref)
    assert doc["session"]["metrics_scrape_ok"]
    assert doc["session"]["healthz_compute_ok"]
    rename = {"device_kind": "device_name", "jax": "torch"}
    assert set(doc) == set(ref)
    assert set(doc["session"]) == set(ref["session"])
    assert doc["session"]["structural_fingerprint"] == \
        ref["session"]["structural_fingerprint"]
    assert set(doc["meta"]) == {rename.get(k, k) for k in ref["meta"]}
    for k in ("model", "shape", "batch", "n_local", "clients", "rounds"):
        assert doc["meta"][k] == ref["meta"][k]
    assert set(doc["probes"]) == set(ref["probes"])
    for name, probe in doc["probes"].items():
        assert probe["ran"] and ref["probes"][name]["ran"]
        assert set(ref["probes"][name]) <= set(probe)
        assert probe["dispatches"] == ref["probes"][name]["dispatches"]
        assert probe["config"] == ref["probes"][name]["config"]
        assert probe["launches"] == {k: 0 for k in probe["launches"]}
    assert [doc["probes"][p["name"]]["dispatches"] for p in MANIFEST] == \
        [5, 2]
    step = doc["xla"]["train_step"]
    assert set(step) >= {"counter_flops", "analytic_flops",
                         "parity_ratio", "peak_bytes"}
    assert step["analytic_flops"] == pytest.approx(
        ref["xla"]["train_step"]["analytic_flops"])


def test_probe_module_cli_runs_on_the_cpu(tmp_path):
    """``python -m ...obs.probe --device cpu`` with a one-probe manifest:
    exit 0, the probe ran, no memory block off the card."""
    man = tmp_path / "m.json"
    man.write_text(json.dumps(MANIFEST[:1]))
    out = tmp_path / "s.json"
    assert PP.main(["--device", "cpu", "--manifest", str(man),
                    "--out", str(out)]) == 0
    probe = json.loads(out.read_text())["probes"]["fp32_baseline"]
    assert probe["ran"] and "memory" not in probe
    assert probe["compiles"] >= 1 and probe["step_replays"] > 0


def test_a_probe_that_raises_fails_the_session(tmp_path, monkeypatch):
    """A probe whose run raises is recorded with its error, the session
    goes on to the next probe and fails."""
    orig = PP.run_probe

    def boom(probe, *a, **k):
        if probe.name == "fp32_baseline":
            raise RuntimeError("out of memory")
        return orig(probe, *a, **k)

    monkeypatch.setattr(PP, "run_probe", boom)
    manifest = tuple(PP.Probe(p["name"], p["cell"]) for p in MANIFEST)
    doc = PP.run_session(manifest, str(tmp_path / "s.json"), device="cpu")
    assert not PP.session_ok(doc)
    assert doc["probes"]["fp32_baseline"]["skip_reason"] == \
        "error: RuntimeError: out of memory"
    assert doc["probes"]["fused_dispatch_k4"]["ran"]


# ------------------------------------------------------------ run report


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A 3-round ``3dcnn_tiny`` FedAvg run of the port's CLI with the
    health stats, a rule that fires every round, the metrics sink and the
    log dir; the flight ring dumped after it. Returns its three files and
    its result line."""
    from neuroimagedisttraining_tpu_torch import __main__ as PM
    from neuroimagedisttraining_tpu_torch.obs import flight as pflight
    from neuroimagedisttraining_tpu_torch.obs import metrics as pmetrics

    d = tmp_path_factory.mktemp("run")
    rules = d / "rules.json"
    rules.write_text(json.dumps([{
        "name": "param-norm-seen", "metric": "nidt_health_param_norm",
        "op": ">", "threshold": 0.0, "severity": "warn"}]))
    pmetrics.reset()
    pflight.clear()
    import contextlib
    import io

    buf = io.StringIO()
    with torch_threads(2), contextlib.redirect_stdout(buf):
        code = PM.main([
            "--algorithm", "fedavg", "--device", "cpu", "--dataset",
            "synthetic", "--model", "3dcnn_tiny", "--synthetic_shape", "12",
            "14", "12", "--synthetic_num_subjects", "32",
            "--client_num_in_total", "4", "--comm_round", "3",
            "--batch_size", "4", "--epochs", "1", "--health_stats",
            "--health_rules", str(rules), "--metrics_out",
            str(d / "metrics.jsonl"), "--log_dir", str(d / "log")])
    flight = pflight.dump(str(d / "flight.json"))
    verdict = next((d / "log").rglob("*.health.json"))
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    return code, str(d / "metrics.jsonl"), flight, str(verdict), result


def test_run_report_matches_the_reference(cli_run, tmp_path):
    code, metrics, flight, verdict, result = cli_run
    assert code == 0
    recs = PR.read_metrics_jsonl(metrics)
    assert recs == JR.read_metrics_jsonl(metrics)
    flight_doc = json.loads(open(flight).read())
    verdict_doc = json.loads(open(verdict).read())
    rep = PR.build_report(recs, flight_doc, verdict_doc)
    assert rep == JR.build_report(recs, flight_doc, verdict_doc)
    assert PR.render_markdown(rep) == JR.render_markdown(rep)
    assert PR.SCHEMA == JR.SCHEMA
    # the report reads the run: its rounds, status, alerts and losses
    s = rep["summary"]
    assert s["joined"] == {"metrics": True, "flight": True, "verdict": True}
    assert s["status"] == verdict_doc["status"] == result["health"]["status"]
    assert [r["round"] for r in rep["rounds"]] == [0, 1, 2]
    assert [r["train_loss"] for r in rep["rounds"]] == pytest.approx(
        [h["train_loss"] for h in result["history"]], rel=1e-6)
    assert s["alerts_total"] >= 1 and any(
        a["rule"] == "param-norm-seen" for a in rep["alerts"])
    assert rep["dispatch"]["dispatches"] > 0
    # the two CLIs write the same report files
    outs = []
    for mod in (PR, JR):
        out = tmp_path / mod.__name__.split(".")[0]
        assert mod.main(["--metrics", metrics, "--flight", flight,
                         "--verdict", verdict, "--out", str(out)]) == 0
        outs.append([(out / f"run_report.{ext}").read_text()
                     for ext in ("json", "md")])
    assert outs[0] == outs[1]
    assert PR.main(["--out", str(tmp_path / "none")]) == 2
