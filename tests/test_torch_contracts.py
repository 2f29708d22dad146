"""The port's project pass (``neuroimagedisttraining_tpu_torch/analysis``:
``core``, ``project``, ``contracts``, ``cli``) against the reference's.

- Both packages' ``lint_project`` on the synthetic fixture trees of
  ``tests/test_contracts.py`` give equal findings: path, line, rule and
  message, exactly, once the package name and the markdown twin's path
  (the reference's ``ARCHITECTURE.md``, the port's
  ``analysis/COMPAT_MATRIX.md``) are mapped. The two families the port
  leaves out (JAX buffer donation, the bench-spec closure) are not run.
- The port's extractor over the reference's tree gives the reference's
  committed ``MATRIX`` row for row.
- The port's own tree: ``--project`` clean, the per-file families clean
  with each pragma's findings pinned by rule and file, every pragma
  justified, the
  committed matrix a fresh extraction, ``--regen-compat`` a no-op, and
  the reference's 17 startup refusals outside ``distributed/run.py`` and
  its 20 in ``distributed/run.py`` held, each matched by its knobs and the
  first words of its message.
- ``--check-manifest`` and ``--dp_epsilon_budget``'s refusals equal the
  reference's; both main CLIs take the control plane's eight flags into
  equal config fields and refuse the same bad values with the same
  messages; both ``distributed/run.py`` parsers refuse the same argv with
  the same messages and accept the same argv, the asynchronous plane's
  five flags included.
"""

import ast
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

import test_contracts as T
from neuroimagedisttraining_tpu.analysis import cli as RC
from neuroimagedisttraining_tpu.analysis import project as RP
from neuroimagedisttraining_tpu.analysis.compat_matrix import MATRIX as RMATRIX
from neuroimagedisttraining_tpu_torch.analysis import RULE_REGISTRY
from neuroimagedisttraining_tpu_torch.analysis import cli as PC
from neuroimagedisttraining_tpu_torch.analysis import core as PCORE
from neuroimagedisttraining_tpu_torch.analysis import project as PP
from neuroimagedisttraining_tpu_torch.analysis.compat_matrix import (
    MATRIX as PMATRIX,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "neuroimagedisttraining_tpu_torch"
REF = "neuroimagedisttraining_tpu"
#: every rule id of the port's project families (the reference runs the
#: same families under the same ids)
PORT_IDS = sorted(rid for cls in RULE_REGISTRY.values()
                  if issubclass(cls, PP.ProjectRule) for rid in cls.rule_ids)


def _write(root, files):
    for rel, src in files.items():
        fp = root / "pkg" / rel
        fp.parent.mkdir(parents=True, exist_ok=True)
        fp.write_text(textwrap.dedent(src))
    return str(root), "pkg"


def _ref_findings(root):
    return [(f.path, f.line, f.rule, f.message)
            for f in RP.lint_project(root, "pkg", rules=PORT_IDS)]


def _port_findings(root):
    """The port's findings with the twin's path and the package's module
    path mapped onto the reference's spelling."""
    twin = PP.twin_relpath("pkg")

    def m(text):
        return (text.replace(twin, "ARCHITECTURE.md")
                .replace("COMPAT_MATRIX.md", "ARCHITECTURE.md")
                .replace(PORT, REF))
    return [(m(f.path), f.line, f.rule, m(f.message))
            for f in PP.lint_project(root, "pkg", rules=PORT_IDS)]


# the inline trees of tests/test_contracts.py (its module constants are
# imported above)
WRAPPER_TREE = {
    "config.py": """
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class ExperimentConfig:
            mesh_shape: tuple = (1, 1)
            snip: bool = True
    """,
    "__main__.py": """
        import argparse

        from pkg.config import ExperimentConfig

        def add_args(parser):
            parser.add_argument("--mesh_shape", type=int, nargs=2,
                                default=[1, 1])
            parser.add_argument("--no_snip", action="store_true")
            return parser

        def config_from_args(args):
            return ExperimentConfig(
                mesh_shape=tuple(args.mesh_shape),
                snip=not args.no_snip)
    """,
}
CLEAN_FLAG_TREE = dict(T.FLAG_CONFIG_TREE, **{"__main__.py": """
        import argparse

        from pkg.config import ExperimentConfig, OptimConfig

        def add_args(parser):
            parser.add_argument("--lr", type=float, default=0.01)
            parser.add_argument("--tag", type=str, default="exp")
            parser.add_argument("--hidden", type=int, default=3)
            return parser

        def config_from_args(args):
            return ExperimentConfig(
                tag=args.tag, hidden=args.hidden,
                optim=OptimConfig(lr=args.lr))
    """})
RUN_PY = """
        import argparse

        def main():
            ap = argparse.ArgumentParser()
            ap.add_argument("--lr", type=float, default=0.05)
            args = ap.parse_args()
            return args.lr
    """
CLEAN_METRIC_TREE = dict(T.METRIC_TREE, **{"train.py": """
        from pkg.obs import metrics as obs_metrics
        from pkg.obs import names as obs_names

        def arm():
            obs_metrics.counter(obs_names.USED, "ok")
            obs_metrics.gauge(obs_names.ORPHAN, "now consumed")
    """})
REASON_TREE = {
    "engines/program.py": """
        REASONS = {
            "used-key": ("host", "why"),
            "orphan-key": ("host", "why"),
        }

        def reason(key):
            return REASONS[key]
    """,
    "engines/base.py": """
        def _report(report_fallback):
            report_fallback("engine", "used-key")

        def thing_fallback_key():
            return "bogus-key"
    """,
}
ONE_KNOB_TREE = {
    "__main__.py": """
        import argparse

        def add_args(parser):
            parser.add_argument("--a_flag", type=int, default=0)
            return parser

        def main():
            parser = argparse.ArgumentParser()
            add_args(parser)
            args = parser.parse_args()
            if args.a_flag < 0:
                parser.error("--a_flag must be >= 0")
            return args
    """,
}
#: a reflex registry with an orphan action, a rule binding an unknown one
ACTION_TREE = {
    "obs/actions.py": """
        BUILTIN_ACTIONS = {
            "quarantine_client": "drop the client",
            "never_fired_action": "nothing binds this",
        }
    """,
    "obs/rules.py": """
        def builtin():
            return [HealthRule(name="a", action="quarantine_client"),
                    HealthRule(name="b", action="ghost_action")]
    """,
}
#: a recipe-key table naming an option the CLI lacks
RECIPE_TREE = {
    "__main__.py": """
        import argparse

        def add_args(parser):
            parser.add_argument("--precision", type=str, default="fp32")
            return parser

        def main():
            args = add_args(argparse.ArgumentParser()).parse_args()
            return args.precision
    """,
    "tune/recipe.py": """
        RECIPE_KEYS = {
            "precision": "--precision",
            "batch": "--batch_size",
        }
    """,
}

FIXTURES = {
    "flag_config": T.FLAG_CONFIG_TREE,
    "flag_config_clean": CLEAN_FLAG_TREE,
    "flag_config_wrappers": WRAPPER_TREE,
    "cross_cli_drift": dict(T.FLAG_CONFIG_TREE,
                            **{"distributed/run.py": RUN_PY}),
    "cross_cli_pragma": dict(T.FLAG_CONFIG_TREE, **{
        "distributed/run.py": RUN_PY.replace(
            'default=0.05)',
            'default=0.05)  '
            '# nidt: allow[flag-config-cross-cli-drift] -- smoke-scale')}),
    "metric_closure": T.METRIC_TREE,
    "metric_closure_clean": CLEAN_METRIC_TREE,
    "reason_closure": REASON_TREE,
    "compat_missing_artifact": T.MATRIX_CLI,
    "compat_one_knob": ONE_KNOB_TREE,
    "actions": ACTION_TREE,
    "recipe_keys": RECIPE_TREE,
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_findings_equal_the_reference(tmp_path, name):
    ref = _ref_findings(_write(tmp_path / "ref", FIXTURES[name])[0])
    port = _port_findings(_write(tmp_path / "port", FIXTURES[name])[0])
    assert port == ref


def test_compat_matrix_lifecycle_equals_the_reference(tmp_path):
    """tests/test_contracts.py's stale-row / hand-edited-twin sequence,
    step by step in both packages: regenerate, add a refusal, regenerate,
    hand-edit the twin, regenerate, remove a refusal."""
    roots = {}
    for side, lib in (("ref", RP), ("port", PP)):
        root, pkg = _write(tmp_path / side, T.MATRIX_CLI)
        lib.regen_compat(root, pkg)
        roots[side] = root

    def both():
        return (_ref_findings(roots["ref"]), _port_findings(roots["port"]))

    def edit(side, rel, old, new):
        fp = tmp_path / side / rel
        fp.write_text(fp.read_text().replace(old, new))

    ref, port = both()
    assert ref == port == []
    for side in ("ref", "port"):
        edit(side, "pkg/__main__.py", "return args",
             'if args.b_flag and not args.a_flag:\n'
             '        parser.error("--b_flag requires --a_flag")\n'
             '    return args')
    ref, port = both()
    assert port == ref and [f[2] for f in ref] == ["compat-matrix-drift"]
    RP.regen_compat(roots["ref"], "pkg")
    PP.regen_compat(roots["port"], "pkg")
    edit("ref", "ARCHITECTURE.md", "`a_flag`", "`tweaked`")
    edit("port", f"pkg/{PP.TWIN}", "`a_flag`", "`tweaked`")
    ref, port = both()
    assert port == ref and [f[2] for f in ref] == ["compat-matrix-doc-stale"]
    RP.regen_compat(roots["ref"], "pkg")
    PP.regen_compat(roots["port"], "pkg")
    for side in ("ref", "port"):
        edit(side, "pkg/__main__.py",
             'parser.error("--b_flag requires --a_flag")', "pass")
    ref, port = both()
    assert port == ref and ref and {f[2] for f in ref} == {
        "compat-matrix-drift"}
    # the port's twin keeps the prose around its generated block
    twin = tmp_path / "port" / "pkg" / PP.TWIN
    twin.write_text("# notes\n\n" + twin.read_text() + "\nmore notes\n")
    PP.regen_compat(roots["port"], "pkg")
    text = twin.read_text()
    assert text.startswith("# notes\n") and text.endswith("more notes\n")


def test_extractor_reproduces_the_reference_matrix():
    model = PP.build_model(REPO, REF)
    rows = PP.rejection_rows(model, PP.knob_vocabulary(model))
    assert [{k: v for k, v in r.items() if not k.startswith("_")}
            for r in rows] == [dict(r, knobs=tuple(r["knobs"]))
                               for r in RMATRIX]
    assert PP.startup_validators(model) == set()


def test_port_tree_project_pass_is_clean_and_every_pragma_justified():
    findings = PP.lint_project(REPO, PORT)
    assert findings == [], "\n" + "\n".join(f.render() for f in findings)
    # the per-file pass is the pragma rule: a bare or unknown pragma fails
    files = PCORE.lint_paths([os.path.join(REPO, PORT)])
    assert files == [], "\n".join(f.render() for f in files)
    pragmas = [p for fp in PCORE.iter_py_files([os.path.join(REPO, PORT)])
               for p in PCORE.parse_pragmas(open(fp).read()).values()]
    assert pragmas and all(p.justification for p in pragmas)


def test_port_tree_suppressions_are_the_documented_ones():
    """What the pragmas hide, read before suppression: the cross-silo
    runner's smoke-scale defaults (the reference's own pragmas) and the
    probe's directory name. Every metric name has its producer: the
    transport and cross-silo series (``distributed/``), the asynchronous
    plane's selector, buffer, ingest and region series (``asyncfl/``);
    none carries a pragma."""
    model = PP.build_model(REPO, PORT)
    raw = [f for cls in RULE_REGISTRY.values()
           if issubclass(cls, PP.ProjectRule)
           for f in cls().project_check(model)]
    by_rule = {}
    for f in raw:
        by_rule.setdefault(f.rule, []).append(f)
    assert sorted(by_rule) == ["flag-config-cross-cli-drift",
                               "metric-undeclared"]
    assert sorted(f.message.split()[0] for f in
                  by_rule["flag-config-cross-cli-drift"]) == [
        "--batch_size", "--comm_round", "--data_dir", "--dataset",
        "--epochs", "--model", "--synthetic_num_subjects",
        "--synthetic_shape"]
    run_py = model.module(f"{PORT}/distributed/run.py").source.splitlines()
    for f in by_rule["flag-config-cross-cli-drift"]:
        # the pragma stands on a line of the flag's add_argument call
        assert f.path.endswith("distributed/run.py")
        assert any("# nidt: allow[flag-config-cross-cli-drift] -- " in ln
                   for ln in run_py[f.line - 1:f.line + 2]), f
    assert [f.message.split("'")[1] for f in by_rule["metric-undeclared"]
            ] == ["nidt_profile"]
    names = model.module(f"{PORT}/obs/names.py").source
    assert "allow[metric-orphan]" not in names


#: what the per-file families' pragmas hide in the port's tree, by rule
#: and file: the transports' single-writer sends (the reference pragmas 33
#: lock-send and 1 lock-shared-map), numpy's global stream in the
#: reference-parity sampling shims (7 in the reference) and the
#: secret-sharing masks' and random topologies' OS entropy (5); and the
#: local step's raw input cast to float32 (the reference pragmas its own)
PER_FILE_PRAGMAS = {
    "lock-send": {"asyncfl/ingest.py": 12, "asyncfl/loadgen.py": 4,
                  "asyncfl/loop.py": 3, "asyncfl/region.py": 4,
                  "distributed/broker.py": 1, "distributed/comm.py": 1,
                  "faults/chaos.py": 1},
    "lock-shared-map": {"asyncfl/loop.py": 1},
    "determinism-global-random": {"engines/base.py": 2,
                                  "engines/dpsgd.py": 3},
    "determinism-unseeded-rng": {"ops/mpc.py": 4, "parallel/topology.py": 1},
    "precision-upcast": {"core/trainer.py": 1},
}


def test_port_tree_per_file_suppressions_are_the_documented_ones():
    """The twelve per-file families over the port's tree (async, lock,
    shm, determinism, privacy, health, engine contract, round program,
    trace safety, obs, mesh and precision), read before suppression: only
    the pinned findings, each under a justified pragma on its statement
    (the per-file pass above is clean)."""
    families = [cls for cls in RULE_REGISTRY.values()
                if not issubclass(cls, PP.ProjectRule)
                and cls.rule_ids[0] != "pragma"]
    assert {rid for cls in families for rid in cls.rule_ids} == {
        "async-blocking-call", "async-queue-get", "lock-send",
        "lock-shared-map", "shm-owner-teardown", "shm-attach-unlink",
        "determinism-global-random", "determinism-unseeded-rng",
        "dp-key-discipline", "health-metric-literal", "engine-attrs",
        "engine-round", "engine-signature", "round-program-fused-body",
        "round-program-reason", "trace-host-sync", "trace-np-random",
        "obs-clock-in-trace", "obs-metrics-in-trace", "obs-sync-in-trace",
        "obs-trace-ctx-key", "obs-pipe-per-upload", "mesh-pad-weights",
        "precision-upcast"}
    raw = collections.defaultdict(collections.Counter)
    root = os.path.join(REPO, PORT)
    for fp in PCORE.iter_py_files([root]):
        with open(fp) as f:
            src = f.read()
        tree = ast.parse(src)
        mod = PCORE.ModuleInfo(path=fp, source=src, tree=tree,
                               pragmas=PCORE.parse_pragmas(src),
                               aliases=PCORE.collect_aliases(tree))
        for cls in families:
            for finding in cls().check(mod):
                raw[finding.rule][os.path.relpath(fp, root)] += 1
                assert finding.rule in src.splitlines()[
                    finding.line - 1], finding
    assert {k: dict(v) for k, v in raw.items()} == PER_FILE_PRAGMAS


def test_project_cli_exits_0_and_regen_compat_changes_nothing(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT}.analysis", "--project"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    shutil.copytree(os.path.join(REPO, PORT), tmp_path / PORT,
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    py_path, md_path = PP.regen_compat(str(tmp_path), PORT)
    for path in (py_path, md_path):
        rel = os.path.relpath(path, tmp_path)
        with open(path, "rb") as a, open(os.path.join(REPO, rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_committed_matrix_matches_fresh_extraction():
    model = PP.build_model(REPO, PORT)
    rows = PP.rejection_rows(model, PP.knob_vocabulary(model))
    assert [{k: v for k, v in r.items() if not k.startswith("_")}
            for r in rows] == [dict(r, knobs=tuple(r["knobs"]))
                               for r in PMATRIX]
    assert PP.committed_matrix(model) == [
        dict(r, knobs=tuple(r["knobs"])) for r in PMATRIX]


def _words(message: str, n: int = 8) -> list[str]:
    return re.findall(r"[a-z0-9_]+", message.lower())[:n]


REF_ROWS = [r for r in RMATRIX if not r["where"].endswith("distributed/run.py")]
#: reference rows the port cannot hold, with the reason (none today)
EXCEPTIONS: dict[tuple, str] = {}


def test_reference_has_17_rows_outside_distributed_run():
    assert len(REF_ROWS) == 17


@pytest.mark.parametrize("row", REF_ROWS, ids=[
    f"{r['where'].rsplit('/', 1)[-1]}:{'+'.join(r['knobs'])}:"
    f"{'_'.join(_words(r['message'], 4))}" for r in REF_ROWS])
def test_port_matrix_holds_the_reference_row(row):
    """Matched by the knobs (the config's ``fed`` aside) and the first 8
    words of the message; ``core/optim.py``'s two rows stand where the
    reference's CLI has them."""
    key = (row["where"].split("/", 1)[1], row["knobs"])
    if key in EXCEPTIONS:
        pytest.fail(f"listed exception without a port row: {EXCEPTIONS[key]}")
    knobs = set(row["knobs"]) - {"fed"}
    hits = [r for r in PMATRIX if set(r["knobs"]) - {"fed"} == knobs
            and _words(r["message"]) == _words(row["message"])]
    assert hits, (row, [r for r in PMATRIX
                        if set(r["knobs"]) - {"fed"} == knobs])


RUN_ROWS = [r for r in RMATRIX if r["where"].endswith("distributed/run.py")]


def test_reference_has_20_rows_in_distributed_run():
    assert len(RUN_ROWS) == 20


@pytest.mark.parametrize("row", RUN_ROWS, ids=[
    f"run:{'+'.join(r['knobs'])}:{'_'.join(_words(r['message'], 4))}"
    for r in RUN_ROWS])
def test_port_run_py_holds_the_reference_row(row):
    """Each startup refusal of the reference's cross-silo runner stands in
    the port's ``distributed/run.py`` with the same knobs and message."""
    hits = [r for r in PMATRIX if r["where"].endswith("distributed/run.py")
            and tuple(r["knobs"]) == tuple(row["knobs"])
            and r["message"] == row["message"]]
    assert len(hits) == 1, row


def test_port_extra_rows_are_the_documented_two():
    extra = [r for r in PMATRIX if not any(
        set(r["knobs"]) - {"fed"} == set(x["knobs"]) - {"fed"}
        and _words(r["message"]) == _words(x["message"]) for x in RMATRIX)]
    assert sorted(r["knobs"] for r in extra) == [
        ("algorithm", "val_fraction"), ("fed", "mpc_backend")]
    twin = open(os.path.join(REPO, PORT, PP.TWIN)).read()
    assert "`(algorithm, val_fraction)`" in twin
    assert "`(fed, mpc_backend)`" in twin


def test_validator_aliases_and_call_sites(tmp_path):
    """A declared validator's guards resolve a local alias of a base and
    take the guards around its call from another validator; the same
    functions undeclared extract nothing (the reference's reading)."""
    files = {
        "config.py": """
            import dataclasses

            STARTUP_VALIDATORS = ("engine.py:_check", "engine.py:_inner")

            @dataclasses.dataclass(frozen=True)
            class FedConfig:
                secure: bool = False
                codec: str = ""
                scale: float = 1.0
                precision: str = "fp32"
        """,
        "engine.py": """
            class Engine:
                def _check(self):
                    f = self.cfg.fed
                    scale = float(f.scale)
                    if scale != 1.0 and f.precision != "bf16":
                        raise ValueError("scale needs bf16")
                    if f.secure:
                        self._inner()

                def _inner(self):
                    f = self.cfg.fed
                    if f.codec:
                        raise ValueError("secure takes no codec")
        """,
    }
    root, pkg = _write(tmp_path / "a", files)
    model = PP.build_model(root, pkg)
    rows = PP.rejection_rows(model, PP.knob_vocabulary(model))
    assert [(r["knobs"], r["message"]) for r in rows] == [
        (("codec", "secure"), "secure takes no codec"),
        (("precision", "scale"), "scale needs bf16")]
    files["config.py"] = files["config.py"].replace(
        'STARTUP_VALIDATORS = ("engine.py:_check", "engine.py:_inner")', "")
    root, pkg = _write(tmp_path / "b", files)
    model = PP.build_model(root, pkg)
    assert PP.rejection_rows(model, PP.knob_vocabulary(model)) == []


# ---------------- --check-manifest ----------------

def _manifest(tmp_path, name, rules):
    path = tmp_path / name
    path.write_text(json.dumps(rules))
    return str(path)


@pytest.mark.parametrize("kind", ["example", "undeclared", "missing_keys",
                                  "not_a_list"])
def test_check_manifest_equals_the_reference(tmp_path, capsys, kind):
    path = {
        "example": os.path.join(REPO, "scripts",
                                "health_rules.example.json"),
        "undeclared": _manifest(tmp_path, "u.json", [{
            "name": "ghost", "metric": "nidt_ghost_metric", "op": ">",
            "threshold": 1}]),
        "missing_keys": _manifest(tmp_path, "m.json", [
            {"name": "half", "metric": "nidt_mfu"}, "not an object"]),
        "not_a_list": _manifest(tmp_path, "n.json", {"rules": []}),
    }[kind]
    out = []
    for main in (RC.main, PC.main):
        rc = main(["--check-manifest", path])
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    assert out[0] == out[1]
    assert out[0][0] == (0 if kind == "example" else
                         2 if kind == "not_a_list" else 1)


# ---------------- the per-file pass, its cache, the CLI ----------------

def test_cache_hit_equals_cold_run(tmp_path, monkeypatch):
    target = tmp_path / "mod.py"
    target.write_text("x = 1  # nidt: allow[metric-orphan]\n")
    cache = tmp_path / "cache"
    cold = PCORE.lint_paths([str(target)], cache_dir=str(cache))
    assert [f.rule for f in cold] == ["pragma"]
    assert "missing justification" in cold[0].message
    assert list(cache.glob("*.json"))

    def boom(*a, **k):
        raise AssertionError("cache miss: lint_source was called")

    monkeypatch.setattr(PCORE, "lint_source", boom)
    assert PCORE.lint_paths([str(target)], cache_dir=str(cache)) == cold
    monkeypatch.undo()
    target.write_text("x = 1  # nidt: allow[bogus-rule] -- why\n")
    changed = PCORE.lint_paths([str(target)], cache_dir=str(cache))
    assert [f.message for f in changed] == [
        "unknown rule id 'bogus-rule' in allow[]"]


def test_cli_paths_list_rules_and_usage(tmp_path, capsys):
    target = tmp_path / "mod.py"
    target.write_text("x = 1  # nidt: allow[] -- nothing named\n")
    assert PC.main([str(target), "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in report] == ["pragma"]
    assert PC.main([]) == 2
    capsys.readouterr()
    assert PC.main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for rid in ("pragma", "flag-config-default-drift", "metric-orphan",
                "reason-orphan", "recipe-key-closure", "action-orphan",
                "compat-matrix-drift"):
        assert rid in listed
    assert "donation" not in listed and "bench-spec" not in listed
    cwd = os.getcwd()
    os.chdir(tmp_path)  # outside any checkout: --changed-files lints all
    try:
        assert PC.main([str(target), "--changed-files"]) == 1
    finally:
        os.chdir(cwd)
    capsys.readouterr()
    assert PC.main(["--project", "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == []


def test_project_rules_do_not_change_the_per_file_pass():
    families = [cls for cls in RULE_REGISTRY.values()
                if issubclass(cls, PP.ProjectRule)]
    assert sorted(cls.__name__ for cls in families) == [
        "ActionDisciplineRule", "CompatMatrixRule", "FlagConfigRule",
        "MetricClosureRule", "ReasonClosureRule", "RecipeKeyClosureRule"]
    for cls in families:
        assert list(cls().check(object())) == []


# ---------------- --dp_epsilon_budget at argparse ----------------

class _Accepted(Exception):
    pass


DP_ARGV = {
    "negative": ["--dp_epsilon_budget", "-1"],
    "no_noise_path": ["--dp_epsilon_budget", "5"],
    "dp_sigma": ["--algorithm", "dpsgd", "--dp_clip", "1", "--dp_sigma",
                 "1.1", "--dp_epsilon_budget", "5"],
    "weak_dp": ["--defense_type", "weak_dp", "--dp_epsilon_budget", "5"],
}


@pytest.mark.parametrize("case", sorted(DP_ARGV))
def test_dp_epsilon_budget_refusals_equal_the_reference(case, capsys,
                                                        monkeypatch):
    """The same argv through both CLIs: refused with equal messages, or
    accepted by both (the reference's main stops, by a stub, at the first
    step past its argparse checks)."""
    from neuroimagedisttraining_tpu import __main__ as RM
    from neuroimagedisttraining_tpu.utils import compile_cache
    from neuroimagedisttraining_tpu_torch import __main__ as PM

    def accept(*a, **k):
        raise _Accepted

    monkeypatch.setattr(compile_cache, "enable_compile_cache", accept)
    argv = ["--dataset", "synthetic", *DP_ARGV[case]]
    outcome = []
    for run in (lambda: RM.main(argv), lambda: PM.parse(argv)):
        try:
            run()
            result = "accepted"
        except _Accepted:
            result = "accepted"
        except SystemExit as e:
            err = capsys.readouterr().err
            result = (e.code, err.strip().splitlines()[-1].split(
                "error: ", 1)[1])
        outcome.append(result)
    assert outcome[0] == outcome[1]
    assert (outcome[0] == "accepted") == (case in ("dp_sigma", "weak_dp"))


# ---------------- the control plane's flags on the main CLI ----------------

CONTROL_ARGV = {
    "defaults": [],
    "deadline": ["--round_deadline", "2.5", "--quorum", "3"],
    "heartbeat": ["--heartbeat_interval", "0.5", "--heartbeat_timeout",
                  "2"],
    "async": ["--async_server", "--buffer_k", "4", "--staleness_alpha",
              "0.25", "--max_staleness", "7"],
    "bad_quorum": ["--quorum", "two"],
    "bad_deadline": ["--round_deadline", "soon"],
    "bad_buffer_k": ["--buffer_k", "1.5"],
}
CONTROL_FIELDS = ("round_deadline", "quorum", "heartbeat_interval",
                  "heartbeat_timeout", "async_server", "buffer_k",
                  "staleness_alpha", "max_staleness")


@pytest.mark.parametrize("case", sorted(CONTROL_ARGV))
def test_main_cli_control_plane_flags_equal_the_reference(case, capsys):
    """The eight flags through both main CLIs' parsers: the same config
    fields (the reference's names and defaults), or the same refusal."""
    import argparse

    from neuroimagedisttraining_tpu import __main__ as RM
    from neuroimagedisttraining_tpu_torch import __main__ as PM

    argv = ["--dataset", "synthetic", *CONTROL_ARGV[case]]
    outcome = []
    for mod in (RM, PM):
        try:
            args = mod.add_args(argparse.ArgumentParser()).parse_args(argv)
            fed = mod.config_from_args(args).fed
            outcome.append({f: getattr(fed, f) for f in CONTROL_FIELDS})
        except SystemExit as e:
            err = capsys.readouterr().err
            outcome.append((e.code, err.strip().splitlines()[-1].split(
                "error: ", 1)[1]))
    assert outcome[0] == outcome[1]
    assert isinstance(outcome[0], dict) == (not case.startswith("bad"))


# ---------------- the cross-silo runner's parsers ----------------

_SRV = ["--role", "server", "--num_clients", "2"]
RUN_ARGV = {
    "accept_plain": _SRV,
    "accept_tolerant": _SRV + ["--round_deadline", "2",
                               "--heartbeat_interval", "0.5",
                               "--heartbeat_timeout", "2"],
    "accept_grouped": _SRV + ["--secure", "--n_aggregators", "3"],
    "accept_sq_weak_dp": _SRV + ["--secure_quant", "--defense", "weak_dp"],
    "accept_broker_chaos": _SRV + ["--transport", "broker", "--fault_spec",
                                   "crash:2@1", "--wire_codec",
                                   "delta+sparse+quant"],
    "aggregator_without_n": ["--role", "aggregator", "--num_clients", "2"],
    "slot_out_of_range": ["--role", "aggregator", "--num_clients", "2",
                          "--secure", "--n_aggregators", "3",
                          "--slot_index", "5"],
    "n_aggregators_plain": _SRV + ["--n_aggregators", "3"],
    "n_aggregators_shares": _SRV + ["--secure", "--n_aggregators", "2"],
    "broker_grouped": _SRV + ["--secure", "--n_aggregators", "3",
                              "--transport", "broker"],
    "secure_codec": _SRV + ["--secure", "--wire_codec", "delta"],
    "secure_mask": _SRV + ["--secure", "--wire_mask_density", "0.5"],
    "sq_grouped": _SRV + ["--secure_quant", "--n_aggregators", "3"],
    "mask_density": _SRV + ["--wire_mask_density", "1.5"],
    "bad_codec": _SRV + ["--wire_codec", "bogus"],
    "bad_defense": _SRV + ["--defense", "bogus"],
    "krum_small": _SRV + ["--defense", "krum"],
    "rejoin": _SRV + ["--fault_spec", "crash:2@1,rejoin:2@3"],
    "secure_quarantine": _SRV + ["--secure", "--quarantine_rounds", "2"],
    "secure_defense": _SRV + ["--secure", "--defense", "weak_dp"],
    "sq_order_stat": ["--role", "server", "--num_clients", "3",
                      "--secure_quant", "--defense", "median"],
    "secure_byz": _SRV + ["--secure", "--fault_spec", "byz:1@0:sign_flip"],
    "async_dense_secure": _SRV + ["--async_server", "--secure"],
    "async_broker": _SRV + ["--async_server", "--transport", "broker"],
    "async_deadline": _SRV + ["--async_server", "--round_deadline", "2"],
    "async_negative": _SRV + ["--async_server", "--buffer_k", "-1"],
    "async_sq_capacity": _SRV + ["--async_server", "--secure_quant",
                                 "--secure_quant_field_bits", "8"],
    "ingest_without_async": _SRV + ["--ingest_workers", "2"],
    "ingest_defense": ["--role", "server", "--num_clients", "3",
                       "--async_server", "--ingest_workers", "2",
                       "--defense", "median"],
    "regions_without_ingest": _SRV + ["--regions", "2"],
    "shm_without_ingest": _SRV + ["--ingest_shm"],
    "sync_delta_without_ingest": _SRV + ["--sync_delta"],
    "heartbeat_order": _SRV + ["--heartbeat_timeout", "1",
                               "--heartbeat_interval", "2"],
    "sq_headroom": ["--role", "server", "--num_clients", "64",
                    "--secure_quant", "--secure_quant_field_bits", "8"],
    "dp_budget": _SRV + ["--dp_epsilon_budget", "-1"],
    "bad_role": ["--role", "observer", "--num_clients", "2"],
    "async_accepted": _SRV + ["--async_server"],
    "async_ingest_accepted": _SRV + ["--async_server", "--ingest_workers",
                                     "2", "--regions", "2", "--ingest_shm",
                                     "--sync_delta"],
    "accept_async_sq": _SRV + ["--async_server", "--secure_quant",
                               "--secure_quant_field_bits", "32",
                               "--ingest_workers", "2", "--regions", "2"],
    "accept_async_client": ["--role", "client", "--rank", "2",
                            "--num_clients", "3", "--async_server",
                            "--buffer_k", "2", "--max_staleness", "4",
                            "--fault_spec", "straggle:0.5:0.2",
                            "--wire_codec", "delta+sparse+quant"],
    "accept_async_ingest_heartbeat": _SRV + [
        "--async_server", "--ingest_workers", "1", "--sync_delta",
        "--heartbeat_interval", "0.5", "--heartbeat_timeout", "2"],
    "ingest_negative": _SRV + ["--async_server", "--ingest_workers", "-1"],
    "regions_negative": _SRV + ["--async_server", "--ingest_workers", "2",
                                "--regions", "-1"],
    "regions_without_async": _SRV + ["--ingest_workers", "2", "--regions",
                                     "2"],
    "shm_sync_delta_async_only": _SRV + ["--async_server", "--ingest_shm",
                                         "--sync_delta"],
    "ingest_quarantine": _SRV + ["--async_server", "--ingest_workers", "2",
                                 "--quarantine_rounds", "2"],
    "async_staleness_negative": _SRV + ["--async_server",
                                        "--staleness_alpha", "-0.5"],
}
#: argv both parsers accept that does not spell ``accept`` in its name
ACCEPTED = ("async_accepted", "async_ingest_accepted")


@pytest.mark.parametrize("case", sorted(RUN_ARGV))
def test_run_py_parsers_equal_the_reference(case, capsys, monkeypatch):
    """The same argv through both ``distributed/run.py`` parsers: refused
    with equal messages, or accepted by both (the reference's ``main``
    stops, by a stub, at its first step past the checks)."""
    from neuroimagedisttraining_tpu.distributed import run as RR
    from neuroimagedisttraining_tpu.utils import compile_cache
    from neuroimagedisttraining_tpu_torch.distributed import run as PR

    def accept(*a, **k):
        raise _Accepted

    monkeypatch.setattr(compile_cache, "enable_compile_cache", accept)
    outcome = []
    for run in (lambda: RR.main(RUN_ARGV[case]),
                lambda: PR.parse(RUN_ARGV[case])):
        try:
            run()
            result = "accepted"
        except _Accepted:
            result = "accepted"
        except SystemExit as e:
            err = capsys.readouterr().err
            result = (e.code, err.strip().splitlines()[-1].split(
                "error: ", 1)[1])
        outcome.append(result)
    assert outcome[0] == outcome[1]
    assert (outcome[0] == "accepted") == (case.startswith("accept")
                                          or case in ACCEPTED)
