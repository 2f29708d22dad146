"""``nidtlint`` command line: ``python -m neuroimagedisttraining_tpu_torch.analysis``.

Exit codes: 0 clean, 1 findings, 2 usage error. Default output is one
``file:line rule-id message`` per finding; ``--json`` emits a machine-
readable report for CI annotation.

Beyond the per-file pass:

- ``--project`` runs the whole-program contract checker
  (analysis/contracts.py) over the cross-file model instead of linting
  the given paths.
- ``--cache [DIR]`` memoizes per-file findings by content hash
  (default ``.nidtlint_cache/``, gitignored); ``--changed-files``
  restricts the per-file pass to files git reports as modified or
  untracked (falls back to linting everything when git is unavailable).
- ``--regen-compat`` rewrites the generated compatibility-matrix
  artifact (analysis/compat_matrix.py) and its markdown twin
  (analysis/COMPAT_MATRIX.md).
- ``--check-manifest FILE`` validates a health-rule JSON manifest's
  metric names against obs/names.py without importing the runtime (or
  torch): a script's gate before it hands a manifest to
  ``--health_rules``.

The per-file pass runs the ``pragma`` rule and the async, lock, shm,
determinism, privacy and health families (the reference's ids); the
families of captured steps, the engine contract and the round program are
still to come.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Sequence

from neuroimagedisttraining_tpu_torch.analysis import lint_paths
from neuroimagedisttraining_tpu_torch.analysis.core import RULE_REGISTRY

DEFAULT_CACHE = ".nidtlint_cache"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m neuroimagedisttraining_tpu_torch.analysis",
        description=("nidtlint: AST invariant checker of the port: the "
                     "per-file families over paths, plus the --project "
                     "whole-program contract pass"))
    p.add_argument("paths", nargs="*",
                   help="files or directories to lint")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit findings as a JSON array")
    p.add_argument("--rules", default=None, metavar="ID[,ID...]",
                   help="only run the named rule ids")
    p.add_argument("--list-rules", action="store_true",
                   help="print every rule family and exit")
    p.add_argument("--project", action="store_true",
                   help="run the cross-file contract checker over the "
                        "package tree instead of the per-file pass")
    p.add_argument("--cache", nargs="?", const=DEFAULT_CACHE, default=None,
                   metavar="DIR",
                   help="memoize per-file findings by content hash "
                        f"(default dir: {DEFAULT_CACHE})")
    p.add_argument("--changed-files", action="store_true",
                   help="per-file pass: only lint files git reports as "
                        "changed/untracked (everything, if git fails)")
    p.add_argument("--regen-compat", action="store_true",
                   help="regenerate analysis/compat_matrix.py and the "
                        "analysis/COMPAT_MATRIX.md block, then exit")
    p.add_argument("--check-manifest", default=None, metavar="FILE",
                   help="validate a health-rule JSON manifest's metric "
                        "names against obs/names.py, then exit")
    return p


def _git_changed(repo_root: str) -> set[str] | None:
    """Absolute paths of modified + untracked files, or None when git
    is unusable (not a checkout, binary missing, ...)."""
    out: set[str] = set()
    for cmd in (["git", "diff", "--name-only", "HEAD"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            res = subprocess.run(cmd, cwd=repo_root, capture_output=True,
                                 text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if res.returncode != 0:
            return None
        out |= {os.path.abspath(os.path.join(repo_root, line))
                for line in res.stdout.splitlines() if line.strip()}
    return out


def _check_manifest(path: str) -> int:
    """Metric-closure validation of a health-rule manifest: every rule's
    ``metric`` must be a value declared in obs/names.py. Static — the
    manifest is judged without importing the runtime (or torch)."""
    from neuroimagedisttraining_tpu_torch.analysis.project import (
        build_model, default_root, names_table)
    try:
        with open(path, encoding="utf-8") as fh:
            rules = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        print(f"error: cannot read manifest {path}: {e}", file=sys.stderr)
        return 2
    if not isinstance(rules, list):
        print(f"error: manifest {path} must be a JSON array of rule "
              "objects", file=sys.stderr)
        return 2
    root, package = default_root()
    names_mod = build_model(root, package).find("obs/names.py")
    declared = ({v for v, _ in names_table(names_mod).values()}
                if names_mod else set())
    bad = 0
    for i, rule in enumerate(rules):
        if not isinstance(rule, dict):
            print(f"{path}: rule[{i}] is not an object", file=sys.stderr)
            bad += 1
            continue
        missing = [k for k in ("name", "metric", "op", "threshold")
                   if k not in rule]
        if missing:
            print(f"{path}: rule[{i}] ({rule.get('name', '?')}) lacks "
                  f"required keys: {', '.join(missing)}", file=sys.stderr)
            bad += 1
        metric = rule.get("metric")
        if metric is not None and metric not in declared:
            print(f"{path}: rule[{i}] ({rule.get('name', '?')}) watches "
                  f"undeclared metric {metric!r} — not in obs/names.py; "
                  "the rule would be permanently dark", file=sys.stderr)
            bad += 1
    if bad:
        print(f"nidtlint: manifest {path}: {bad} problem(s)",
              file=sys.stderr)
        return 1
    print(f"nidtlint: manifest {path}: {len(rules)} rule(s) OK, all "
          "metrics declared")
    return 0


def main(argv: Sequence[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for cls in RULE_REGISTRY.values():
            print(f"{', '.join(cls.rule_ids)}: {cls.description}")
        return 0
    if args.check_manifest is not None:
        return _check_manifest(args.check_manifest)
    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    if args.regen_compat:
        from neuroimagedisttraining_tpu_torch.analysis.project import regen_compat
        py_path, md_path = regen_compat()
        print(f"regenerated {py_path}")
        print(f"regenerated {md_path} (compat-matrix block)")
        return 0
    if args.project:
        from neuroimagedisttraining_tpu_torch.analysis.project import lint_project
        try:
            findings = lint_project(rules=rules)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    else:
        if not args.paths:
            print("error: no paths given (try --list-rules)",
                  file=sys.stderr)
            return 2
        paths = list(args.paths)
        if args.changed_files:
            changed = _git_changed(os.getcwd())
            if changed is not None:
                from neuroimagedisttraining_tpu_torch.analysis.core import (
                    iter_py_files)
                paths = [fp for fp in iter_py_files(paths)
                         if os.path.abspath(fp) in changed]
                if not paths:
                    print("nidtlint: no changed .py files under the "
                          "given paths")
                    return 0
            else:
                print("nidtlint: git unavailable — linting everything",
                      file=sys.stderr)
        try:
            findings = lint_paths(paths, rules=rules, cache_dir=args.cache)
        except (FileNotFoundError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    if args.as_json:
        print(json.dumps([f.as_json() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        if findings:
            print(f"nidtlint: {len(findings)} finding(s) "
                  f"across {len({f.path for f in findings})} file(s)",
                  file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":  # pragma: no cover - exercised via __main__.py
    sys.exit(main())
