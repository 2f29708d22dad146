"""Whole-program contract families over the declarative surfaces (the
reference package's ``analysis/contracts.py``).

Three cross-file contracts ride the project model (analysis/project.py),
run under ``python -m neuroimagedisttraining_tpu_torch.analysis --project``:

1. **flag<->config** — every CLI flag is consumed (mapped into a config
   field by ``config_from_args`` or read as ``args.<dest>``), every
   config field is constructible from the CLI, argparse and dataclass
   defaults agree through the mapping's wrappers, and a flag declared
   on two CLIs agrees on type/default/choices/action.
2. **metric-name closure** — every metric registration and every
   ``names.<CONST>`` consumer resolves to ``obs/names.py``; a declared
   name nothing references is an orphan finding.
3. **compatibility matrix as data** — the startup-rejection sites
   (``parser.error``/``ap.error`` guards, ctor and declared-validator
   ``ValueError`` guards reading >= 2 knobs) are extracted and diffed
   against the committed ``analysis/compat_matrix.py`` artifact and its
   markdown twin ``analysis/COMPAT_MATRIX.md``; drift in either
   direction is a finding, and the twin must be regenerated, never
   hand-edited.

Every family suppresses through the standard ``# nidt: allow[rule-id]
-- why`` pragma on the flagged line. The REASONS, RECIPE_KEYS and
reflex-action closures ride family 2's spirit (names must resolve;
orphans surface). Two of the reference's families are not here: the
interprocedural donation family checks JAX buffer donation, which the
port does not have, and the bench-spec closure comes with the port's
``bench_gate.py`` once the port has bench artifacts of its own.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from neuroimagedisttraining_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    register,
)
from neuroimagedisttraining_tpu_torch.analysis.project import (
    MD_BEGIN,
    UNEVAL,
    FlagInfo,
    ProjectModel,
    ProjectRule,
    apply_wrapper,
    argparse_flags,
    attr_reads,
    committed_matrix,
    config_assigned_fields,
    config_mapping,
    dataclass_fields,
    doc_matrix_block,
    knob_vocabulary,
    metric_registrations,
    names_attr_uses,
    names_table,
    reason_key_uses,
    reasons_span,
    reasons_table,
    rejection_rows,
    render_matrix_md,
    string_literals,
    twin_relpath,
)

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


# ---------------------------------------------------------------------------
# family 1: flag <-> config
# ---------------------------------------------------------------------------

def _fmt(value: object) -> str:
    return "<uneval>" if value is UNEVAL else repr(value)


@register
class FlagConfigRule(ProjectRule):
    rule_ids = ("flag-config-default-drift", "flag-config-unmapped-flag",
                "flag-config-unmapped-field", "flag-config-cross-cli-drift")
    description = (
        "CLI flags and config dataclass fields must stay in lockstep: "
        "every flag consumed, every field constructible, defaults equal "
        "through the config_from_args wrappers, and flags shared by both "
        "CLIs agree on type/default/choices")

    def project_check(self, model: ProjectModel) -> Iterator[Finding]:
        main_cli = model.module(f"{model.package}/__main__.py")
        dist_cli = model.find("distributed/run.py")
        cfg = model.module(f"{model.package}/config.py")
        main_flags = argparse_flags(main_cli) if main_cli else {}
        dist_flags = argparse_flags(dist_cli) if dist_cli else {}
        if main_cli is not None:
            yield from self._check_consumed(main_cli, main_flags)
        if dist_cli is not None:
            yield from self._check_consumed(dist_cli, dist_flags)
        if main_cli is not None and cfg is not None:
            yield from self._check_mapping(main_cli, cfg, main_flags)
        if main_cli is not None and dist_cli is not None:
            yield from self._check_cross_cli(main_flags, dist_flags,
                                             dist_cli.path)

    def _check_consumed(self, cli: ModuleInfo,
                        flags: dict[str, FlagInfo]) -> Iterator[Finding]:
        mapped = {m.dest for m in config_mapping(cli)}
        read = attr_reads(cli, "args")
        for dest, flag in flags.items():
            if dest not in mapped and dest not in read:
                yield Finding(
                    cli.path, flag.lineno, "flag-config-unmapped-flag",
                    f"flag {flag.options[0]} (dest {dest!r}) is declared "
                    "but never consumed — neither mapped into a config "
                    "field by config_from_args nor read as "
                    f"args.{dest} anywhere in this CLI")

    def _check_mapping(self, cli: ModuleInfo, cfg: ModuleInfo,
                       flags: dict[str, FlagInfo]) -> Iterator[Finding]:
        fields = dataclass_fields(cfg)
        mappings = config_mapping(cli)
        assigned = config_assigned_fields(cli)
        # field coverage: every dataclass field is constructible from the
        # CLI path (assigned SOMETHING in config_from_args)
        for cls, cls_fields in fields.items():
            covered = assigned.get(cls, set())
            for name, info in cls_fields.items():
                if name not in covered:
                    yield Finding(
                        cfg.path, info.lineno, "flag-config-unmapped-field",
                        f"{cls}.{name} is not assigned by config_from_args "
                        "— the field cannot be set from the CLI (add a "
                        "flag + mapping, or pragma-justify why it is "
                        "internal-only)")
        # default agreement through the wrapper
        for m in mappings:
            flag = flags.get(m.dest)
            field = fields.get(m.cls, {}).get(m.field)
            if flag is None or field is None:
                continue
            if flag.default is UNEVAL or field.default is UNEVAL:
                continue
            expected = apply_wrapper(flag.default, m.wrapper)
            if expected is UNEVAL:
                continue
            if expected != field.default:
                yield Finding(
                    cli.path, m.lineno, "flag-config-default-drift",
                    f"default drift: {flag.options[0]} defaults to "
                    f"{_fmt(flag.default)} (-> {_fmt(expected)} after "
                    f"{m.wrapper or 'identity'} wrapper) but "
                    f"{m.cls}.{m.field} defaults to {_fmt(field.default)} "
                    "— a config built in code and one built from the CLI "
                    "silently diverge")

    def _check_cross_cli(self, main_flags: dict[str, FlagInfo],
                         dist_flags: dict[str, FlagInfo],
                         dist_path: str) -> Iterator[Finding]:
        by_option = {opt: f for f in main_flags.values()
                     for opt in f.options}
        for flag in dist_flags.values():
            for opt in flag.options:
                twin = by_option.get(opt)
                if twin is None:
                    continue
                drifts = []
                if flag.type != twin.type:
                    drifts.append(f"type {flag.type}!={twin.type}")
                if flag.action != twin.action:
                    drifts.append(f"action {flag.action}!={twin.action}")
                if (flag.default is not UNEVAL and twin.default is not UNEVAL
                        and flag.default != twin.default):
                    drifts.append(f"default {_fmt(flag.default)}!="
                                  f"{_fmt(twin.default)}")
                if (flag.choices is not UNEVAL and twin.choices is not UNEVAL
                        and flag.choices != twin.choices):
                    drifts.append(f"choices {_fmt(flag.choices)}!="
                                  f"{_fmt(twin.choices)}")
                if drifts:
                    yield Finding(
                        dist_path, flag.lineno, "flag-config-cross-cli-drift",
                        f"{opt} is declared on both CLIs but drifts: "
                        + "; ".join(drifts)
                        + " — the same flag spelling must mean the same "
                        "thing everywhere (or pragma-justify the "
                        "smoke-scale divergence)")
                break  # one shared option string is enough to pair them


# ---------------------------------------------------------------------------
# family 2: metric-name closure (+ REASONS, recipe-key and action closures)
# ---------------------------------------------------------------------------

_METRIC_LITERAL_RE = re.compile(r"nidt_[a-z0-9_]+\Z")


@register
class MetricClosureRule(ProjectRule):
    rule_ids = ("metric-undeclared", "metric-orphan")
    description = (
        "every registered/consumed metric name must resolve to an "
        "obs/names.py declaration (metric-undeclared); a declared name "
        "with zero consumers anywhere is an orphan (metric-orphan)")

    def project_check(self, model: ProjectModel) -> Iterator[Finding]:
        names_mod = model.find("obs/names.py")
        if names_mod is None:
            return
        table = names_table(names_mod)
        values = {v for v, _ in table.values()}
        # every top-level binding is a legal `names.X` attribute target
        # (DECLARED, helper tuples, ...), not just the string constants
        module_attrs = set(table)
        for stmt in names_mod.tree.body:
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        module_attrs.add(t.id)
            elif (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)):
                module_attrs.add(stmt.target.id)
            elif isinstance(stmt, _FUNCS):
                module_attrs.add(stmt.name)

        used: set[str] = set()  # declared CONSTs with at least one consumer

        for rel, const, line in names_attr_uses(model):
            if rel == names_mod.path:
                continue
            if const in table:
                used.add(const)
            elif const not in module_attrs:
                yield Finding(
                    rel, line, "metric-undeclared",
                    f"names.{const} is not declared in obs/names.py — "
                    "declare the metric name there (the single source of "
                    "truth) before consuming it")

        for reg in metric_registrations(model):
            if reg.const is not None:
                if reg.const in table:
                    used.add(reg.const)
                else:
                    yield Finding(
                        reg.relpath, reg.lineno, "metric-undeclared",
                        f"{reg.kind}() registers names.{reg.const}, which "
                        "obs/names.py does not declare")
            elif reg.literal is not None:
                if reg.literal in values:
                    used |= {c for c, (v, _) in table.items()
                             if v == reg.literal}
                else:
                    yield Finding(
                        reg.relpath, reg.lineno, "metric-undeclared",
                        f"{reg.kind}() registers literal "
                        f"{reg.literal!r}, which obs/names.py does not "
                        "declare — add the constant and spell it "
                        "names.<CONST>")

        # nidt_* literals inside obs/ (names.py exempt): the per-file
        # health-metric-literal rule stops at the obs/ boundary; here the
        # literal must at least resolve to a declared value
        for rel, mod in model.modules.items():
            if "/obs/" not in f"/{rel}" or rel == names_mod.path:
                continue
            for value, line in string_literals(mod):
                if not _METRIC_LITERAL_RE.fullmatch(value):
                    continue
                if value in values:
                    used |= {c for c, (v, _) in table.items() if v == value}
                else:
                    yield Finding(
                        rel, line, "metric-undeclared",
                        f"metric literal {value!r} does not resolve to any "
                        "obs/names.py declaration")

        # literal value matches anywhere else in the tree also count as
        # consumption (manifests under tests/, script-built rule dicts)
        for rel, mod in model.modules.items():
            if rel == names_mod.path:
                continue
            for value, _line in string_literals(mod):
                if value in values:
                    used |= {c for c, (v, _) in table.items() if v == value}

        for const, (value, line) in sorted(table.items()):
            if const not in used:
                yield Finding(
                    names_mod.path, line, "metric-orphan",
                    f"{const} = {value!r} is declared but nothing in the "
                    "tree registers or consumes it — delete the "
                    "declaration or wire up its consumer")


@register
class ReasonClosureRule(ProjectRule):
    rule_ids = ("reason-unknown", "reason-orphan")
    description = (
        "every *_fallback_key return and report_fallback()/reason() "
        "literal must name a key of the engines/program.py REASONS "
        "table (reason-unknown); a key nothing references is an orphan "
        "(reason-orphan)")

    def project_check(self, model: ProjectModel) -> Iterator[Finding]:
        table = reasons_table(model)
        if not table:
            return
        used: set[str] = set()
        for rel, key, line in reason_key_uses(model):
            if key in table:
                used.add(key)
            else:
                yield Finding(
                    rel, line, "reason-unknown",
                    f"fallback reason {key!r} is not a key of the "
                    "engines/program.py REASONS table — the structured "
                    "nidt_fallback_total counter would carry an "
                    "unexplained label")
        # loose consumption: the key literal spelled anywhere outside the
        # table itself (program.py's own builder emits keys inline)
        span = reasons_span(model)
        prog = model.find("engines/program.py")
        for rel, mod in model.modules.items():
            for value, line in string_literals(mod):
                if value not in table:
                    continue
                if (prog is not None and rel == prog.path
                        and span[0] <= line <= span[1]):
                    continue
                used.add(value)
        for key, line in sorted(table.items()):
            if key not in used:
                yield Finding(
                    (prog.path if prog else "engines/program.py"), line,
                    "reason-orphan",
                    f"REASONS key {key!r} is declared but no fallback "
                    "path ever reports it — delete the row or wire up "
                    "the fallback")


@register
class RecipeKeyClosureRule(ProjectRule):
    rule_ids = ("recipe-key-closure",)
    description = (
        "every committed <package>/recipes/*.json cell key must "
        "resolve through the tune/recipe.py RECIPE_KEYS table to a CLI "
        "option declared on every CLI of the tree — a recipe can never "
        "name a config field the trainers do not declare")

    def project_check(self, model: ProjectModel) -> Iterator[Finding]:
        from neuroimagedisttraining_tpu_torch.analysis.project import (
            committed_recipes,
            recipe_keys_table,
        )
        recipe_mod = model.find("tune/recipe.py")
        if recipe_mod is None:
            return
        table = recipe_keys_table(model)
        if not table:
            yield Finding(
                recipe_mod.path, 1, "recipe-key-closure",
                "tune/recipe.py has no statically-parseable RECIPE_KEYS "
                "dict literal — the closure over committed recipes "
                "cannot be checked")
            return
        cli_options: dict[str, set[str]] = {}
        for suffix in ("/__main__.py", "distributed/run.py"):
            mod = model.find(suffix)
            if mod is not None:
                cli_options[suffix] = {
                    opt for f in argparse_flags(mod).values()
                    for opt in f.options}
        for key, (option, line) in sorted(table.items()):
            for suffix, options in sorted(cli_options.items()):
                if option not in options:
                    yield Finding(
                        recipe_mod.path, line, "recipe-key-closure",
                        f"RECIPE_KEYS maps {key!r} to {option} but the "
                        f"{suffix.lstrip('/')} CLI declares no such "
                        "option — a recipe setting it would apply to a "
                        "nonexistent knob")
        anchor = min(l for _, l in table.values())
        rdir = f"{model.package}/recipes"
        for fn, doc in sorted(committed_recipes(model).items()):
            if not isinstance(doc, dict):
                yield Finding(
                    recipe_mod.path, anchor, "recipe-key-closure",
                    f"committed {rdir}/{fn} does not parse as a JSON "
                    "object — --recipe would die on it at startup; "
                    "regenerate (python -m "
                    "neuroimagedisttraining_tpu_torch.tune)")
                continue
            cell = doc.get("cell")
            if not isinstance(cell, dict):
                yield Finding(
                    recipe_mod.path, anchor, "recipe-key-closure",
                    f"committed {rdir}/{fn} has no 'cell' object — not "
                    "a recipe the loader accepts")
                continue
            for key in sorted(cell):
                if key not in table:
                    yield Finding(
                        recipe_mod.path, anchor, "recipe-key-closure",
                        f"committed {rdir}/{fn} sets "
                        f"cell key {key!r} which RECIPE_KEYS does not "
                        "declare — the loader would reject the file at "
                        "startup")


@register
class ActionDisciplineRule(ProjectRule):
    rule_ids = ("action-unknown", "action-orphan")
    description = (
        "reflex-plane closure: every literal action name — "
        "a HealthRule action= binding, a JSON-manifest 'action' field, "
        "a bus register()/on_alert()/record_action() literal — must "
        "resolve in the obs/actions.py BUILTIN_ACTIONS registry; and "
        "every registered action must be reachable from some rule or "
        "dispatch site (or documented in ARCHITECTURE.md) — a reflex "
        "nothing can ever fire is dead policy")

    def project_check(self, model: ProjectModel) -> Iterator[Finding]:
        from neuroimagedisttraining_tpu_torch.analysis.project import (
            action_uses,
            actions_table,
        )
        actions_mod = model.find("obs/actions.py")
        if actions_mod is None:
            return
        table = actions_table(model)
        if not table:
            yield Finding(
                actions_mod.path, 1, "action-unknown",
                "obs/actions.py has no statically-parseable "
                "BUILTIN_ACTIONS dict literal — the rule->action "
                "closure cannot be checked")
            return
        uses = action_uses(model)
        for rel, name, lineno, kind in uses:
            if rel.endswith("obs/actions.py"):
                continue  # the registry's own docstrings/dispatch glue
            if name not in table:
                yield Finding(
                    rel, lineno, "action-unknown",
                    f"{kind} site names reflex action {name!r} which "
                    "obs/actions.py BUILTIN_ACTIONS does not declare — "
                    "the dispatch would die (register) or log an "
                    "'unhandled' no-op forever (rule binding)")
        # manifest 'action' fields resolve too (the example manifest is
        # the one committed JSON surface binding rules to actions)
        import json as _json
        import os as _os
        mpath = _os.path.join(model.root, "scripts",
                              "health_rules.example.json")
        manifest_names: set[str] = set()
        if _os.path.exists(mpath):
            try:
                with open(mpath, encoding="utf-8") as fh:
                    rows = _json.load(fh)
            except (OSError, _json.JSONDecodeError):
                rows = []
            for i, row in enumerate(rows if isinstance(rows, list)
                                    else []):
                name = (row.get("action", "")
                        if isinstance(row, dict) else "")
                if name:
                    manifest_names.add(name)
                    if name not in table:
                        yield Finding(
                            actions_mod.path, min(table.values()),
                            "action-unknown",
                            f"scripts/health_rules.example.json rule "
                            f"#{i} binds action {name!r} which "
                            "BUILTIN_ACTIONS does not declare — "
                            "loading the manifest would fail at "
                            "startup validation")
        # orphans: registered but unreachable and undocumented
        reachable = {name for rel, name, _, kind in uses
                     if not rel.endswith("obs/actions.py")
                     and kind in ("rule", "dispatch")} | manifest_names
        doc_path = _os.path.join(model.root, "ARCHITECTURE.md")
        doc_text = ""
        if _os.path.exists(doc_path):
            try:
                with open(doc_path, encoding="utf-8") as fh:
                    doc_text = fh.read()
            except OSError:
                pass
        for name, lineno in sorted(table.items()):
            if name not in reachable and name not in doc_text:
                yield Finding(
                    actions_mod.path, lineno, "action-orphan",
                    f"BUILTIN_ACTIONS declares {name!r} but no rule "
                    "binds it, nothing dispatches it, and "
                    "ARCHITECTURE.md does not document it — a reflex "
                    "nothing can ever fire")


# ---------------------------------------------------------------------------
# family 3: compatibility matrix as data
# ---------------------------------------------------------------------------

@register
class CompatMatrixRule(ProjectRule):
    rule_ids = ("compat-matrix-drift", "compat-matrix-doc-stale")
    description = (
        "the committed analysis/compat_matrix.py must equal a fresh "
        "extraction of the tree's startup-rejection sites "
        "(compat-matrix-drift), and the analysis/COMPAT_MATRIX.md table "
        "between the nidt:compat-matrix markers must be regenerated from "
        "it, never hand-edited (compat-matrix-doc-stale); fix both with "
        "--regen-compat")

    def project_check(self, model: ProjectModel) -> Iterator[Finding]:
        extracted = rejection_rows(model, knob_vocabulary(model))
        committed = committed_matrix(model)
        matrix_mod = model.find("analysis/compat_matrix.py")
        matrix_path = (matrix_mod.path if matrix_mod
                       else f"{model.package}/analysis/compat_matrix.py")
        twin = twin_relpath(model.package)
        if committed is None and extracted:
            yield Finding(
                matrix_path, 1, "compat-matrix-drift",
                f"{len(extracted)} startup-rejection site(s) extracted "
                "but no committed compat matrix exists — run "
                "`python -m neuroimagedisttraining_tpu_torch.analysis "
                "--regen-compat` and commit the artifact")
            return
        committed = committed or []
        key = lambda r: (r["where"], tuple(r["knobs"]), r["message"])
        committed_keys = {key(r) for r in committed}
        extracted_keys = {key(r) for r in extracted}
        for row in extracted:
            if key(row) not in committed_keys:
                yield Finding(
                    row["where"], row.get("_line", 1),
                    "compat-matrix-drift",
                    "startup-rejection site (knobs: "
                    + ", ".join(row["knobs"])
                    + ") is missing from the committed compat matrix — "
                    "run --regen-compat and commit "
                    "analysis/compat_matrix.py + the COMPAT_MATRIX.md "
                    "twin")
        for row in committed:
            if key(row) not in extracted_keys:
                yield Finding(
                    matrix_path, 1, "compat-matrix-drift",
                    f"committed matrix row ({row['where']}, knobs: "
                    + ", ".join(row["knobs"])
                    + ") matches no rejection site in today's tree — "
                    "stale row; run --regen-compat")
        # the markdown twin must be byte-identical to a regeneration
        # from the COMMITTED artifact (hand edits are findings even when
        # the artifact itself is current)
        block, line = doc_matrix_block(model)
        expected = render_matrix_md(
            [dict(r, knobs=tuple(r["knobs"])) for r in committed])
        if block is None:
            if committed:
                yield Finding(
                    twin, 1, "compat-matrix-doc-stale",
                    f"{twin} has no nidt:compat-matrix marker "
                    f"block ({MD_BEGIN!r}) — run --regen-compat to embed "
                    "the generated table")
        elif block != expected:
            yield Finding(
                twin, line, "compat-matrix-doc-stale",
                "the compat-matrix table between the nidt:compat-matrix "
                "markers does not match a regeneration from the "
                "committed matrix — the twin is generated, never "
                "hand-edited; run --regen-compat")
