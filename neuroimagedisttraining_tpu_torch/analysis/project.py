"""nidtlint project model (the reference package's ``analysis/project.py``):
the tree parsed ONCE into cross-file facts.

The pragma pass sees one module at a time, so none of the port's
*declarative* contracts are checkable there: a flag the CLI declares and
the config cannot hold, a rule manifest naming a metric nothing
publishes, or a startup refusal the compatibility matrix does not list
all land silently. This module builds the whole-program model those
contracts are stated against — every module parsed once into the same
:class:`ModuleInfo` the per-file pass uses, plus extraction helpers for
each declarative surface:

- argparse ``add_argument`` calls (both CLIs, where a tree has two)
  -> :class:`FlagInfo`
- frozen-dataclass fields + defaults (``config.py``)
- the ``config_from_args`` flag->field mapping (wrapper-aware:
  ``tuple(args.x)``, ``bool(args.x)``, ``not args.x``,
  ``args.x.lower()``)
- ``obs/names.py`` declarations, every ``names.*`` attribute use, and
  every ``obs.metrics.counter/gauge/histogram`` registration site
- the ``engines/program.py`` ``REASONS`` table and its uses
- ``tune/recipe.py`` ``RECIPE_KEYS`` and the committed recipes
  (``<package>/recipes/*.json``)
- the ``obs/actions.py`` ``BUILTIN_ACTIONS`` registry and its uses
- startup-rejection sites (``parser.error``/``ap.error`` in the CLIs,
  ``raise ValueError`` in ctors and in the functions a tree declares as
  its startup validators) -> compatibility-matrix rows

The port refuses a configuration in two places the reference's
``__init__``-only extractor cannot see: the engine's
``_init_defended_round`` (whose guards read a local alias ``f =
self.cfg.fed``) and ``core/optim.py`` ``validate_precision``. A tree
names such functions in a module-level ``STARTUP_VALIDATORS`` tuple of
``"<relpath>:<function>"`` strings in its ``config.py``; inside them the
extractor resolves local aliases of the guard bases and follows a call
from one validator to another within the module. A tree with no such
declaration (the reference's) extracts exactly as the reference does.

The contract rules themselves live in ``analysis/contracts.py``; the
driver is :func:`lint_project` (CLI: ``--project``). Project findings
ride the pragma machinery — a ``# nidt: allow[rule-id] -- why`` on the
flagged line suppresses, with the justification mandatory as everywhere
else. The markdown twin of the matrix is the port's own
``analysis/COMPAT_MATRIX.md`` (:data:`TWIN`).

Dependency-free (stdlib ``ast``/``json``), like the rest of
``analysis/``.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Any, Iterable, Iterator

from neuroimagedisttraining_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Rule,
    _apply_suppressions,
    _selected_rules,
    collect_aliases,
    dotted_name,
    iter_py_files,
    parse_pragmas,
)

#: sentinel for defaults the extractor cannot evaluate statically
UNEVAL = object()


class ProjectRule(Rule):
    """A rule family that checks the cross-file model instead of one
    module. The per-file ``check`` is a no-op so registering a project
    family never changes ``lint_paths`` output; ``project_check`` runs
    only under ``lint_project`` (CLI ``--project``)."""

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        return iter(())

    def project_check(self, model: "ProjectModel") -> Iterator[Finding]:
        raise NotImplementedError


@dataclasses.dataclass
class ProjectModel:
    """Every package module parsed once, keyed by posix path relative
    to ``root`` (the directory CONTAINING the package dir), so findings
    and committed artifacts are stable across checkouts."""

    root: str
    package: str
    modules: dict[str, ModuleInfo]

    def module(self, relpath: str) -> ModuleInfo | None:
        return self.modules.get(relpath)

    def find(self, suffix: str) -> ModuleInfo | None:
        """The unique module whose relpath ends with ``suffix`` (None
        when absent — synthetic fixture trees omit most surfaces)."""
        for rel, mod in self.modules.items():
            if rel.endswith(suffix):
                return mod
        return None


def build_model(root: str, package: str) -> ProjectModel:
    modules: dict[str, ModuleInfo] = {}
    pkg_dir = os.path.join(root, package)
    for fp in iter_py_files([pkg_dir]):
        rel = os.path.relpath(fp, root).replace(os.sep, "/")
        with open(fp, encoding="utf-8") as fh:
            source = fh.read()
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError:
            continue  # the per-file pass owns parse-error findings
        modules[rel] = ModuleInfo(
            path=rel, source=source, tree=tree,
            pragmas=parse_pragmas(source), aliases=collect_aliases(tree))
    return ProjectModel(root=root, package=package, modules=modules)


# ---------------------------------------------------------------------------
# argparse flag surface
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlagInfo:
    """One ``add_argument`` call, statically evaluated."""

    options: tuple[str, ...]
    dest: str
    type: str | None        # 'int' | 'float' | 'str' | None
    default: Any            # UNEVAL when not a literal
    choices: Any            # tuple | UNEVAL | None
    action: str | None      # 'store_true' | ...
    nargs: Any
    required: bool
    lineno: int


def _literal(node: ast.AST | None, default: Any = None) -> Any:
    if node is None:
        return default
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError, TypeError):
        return UNEVAL


def argparse_flags(mod: ModuleInfo) -> dict[str, FlagInfo]:
    """Every ``<parser>.add_argument("--flag", ...)`` in the module,
    keyed by dest. Positional arguments (no leading ``--``) and
    non-constant option strings are skipped."""
    flags: dict[str, FlagInfo] = {}
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            continue
        options = tuple(a.value for a in node.args
                        if isinstance(a, ast.Constant)
                        and isinstance(a.value, str)
                        and a.value.startswith("--"))
        if not options:
            continue
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        dest = _literal(kw.get("dest"))
        if not isinstance(dest, str):
            dest = options[0].lstrip("-").replace("-", "_")
        type_name = None
        if "type" in kw:
            type_name = dotted_name(kw["type"])
        action = _literal(kw.get("action"))
        default = _literal(kw.get("default"), default=None)
        if action == "store_true" and "default" not in kw:
            default = False
        elif action == "store_false" and "default" not in kw:
            default = True
        flags[dest] = FlagInfo(
            options=options, dest=dest,
            type=type_name if isinstance(type_name, str) else None,
            default=default,
            choices=_literal(kw.get("choices"), default=None),
            action=action if isinstance(action, str) else None,
            nargs=_literal(kw.get("nargs"), default=None),
            required=bool(_literal(kw.get("required"), default=False)
                          is True),
            lineno=node.lineno)
    return flags


def attr_reads(mod: ModuleInfo, base: str,
               skip_funcs: tuple[str, ...] = ()) -> set[str]:
    """Every ``<base>.<attr>`` read in the module, optionally excluding
    the bodies of the named top-level functions (``add_args`` declares
    flags, it does not consume them)."""
    skip_spans: list[tuple[int, int]] = []
    for node in ast.walk(mod.tree):
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name in skip_funcs
                and node.end_lineno is not None):
            skip_spans.append((node.lineno, node.end_lineno))
    out: set[str] = set()
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == base):
            if any(a <= node.lineno <= b for a, b in skip_spans):
                continue
            out.add(node.attr)
    return out


# ---------------------------------------------------------------------------
# config dataclasses + the config_from_args mapping
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FieldInfo:
    cls: str
    name: str
    default: Any           # UNEVAL for default_factory / non-literals
    lineno: int


def dataclass_fields(mod: ModuleInfo) -> dict[str, dict[str, FieldInfo]]:
    """Annotated fields of every ``@dataclass`` class, keyed by class
    then field name. ``field(default_factory=...)`` and other
    non-literal defaults come back as UNEVAL (present, not comparable);
    properties and methods are not fields."""
    out: dict[str, dict[str, FieldInfo]] = {}
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        is_dc = any(
            (dotted_name(d) or dotted_name(getattr(d, "func", None)) or "")
            .split(".")[-1] == "dataclass"
            for d in node.decorator_list)
        if not is_dc:
            continue
        fields: dict[str, FieldInfo] = {}
        for stmt in node.body:
            if not (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)):
                continue
            default: Any = UNEVAL
            if stmt.value is not None:
                default = _literal(stmt.value, default=UNEVAL)
            fields[stmt.target.id] = FieldInfo(
                cls=node.name, name=stmt.target.id,
                default=default, lineno=stmt.lineno)
        out[node.name] = fields
    return out


@dataclasses.dataclass(frozen=True)
class Mapping:
    """One ``field=<wrapper>(args.<dest>)`` assignment inside
    ``config_from_args``. ``wrapper`` is None for the identity case."""

    cls: str
    field: str
    dest: str
    wrapper: str | None    # 'tuple' | 'bool' | 'not' | 'lower' | None
    lineno: int


def _resolve_arg_expr(node: ast.AST) -> tuple[str, str | None] | None:
    """(dest, wrapper) for the recognized ``args.<dest>`` shapes."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "args"):
        return node.attr, None
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        inner = _resolve_arg_expr(node.operand)
        if inner and inner[1] is None:
            return inner[0], "not"
    if isinstance(node, ast.Call):
        # tuple(args.x) / bool(args.x)
        if (isinstance(node.func, ast.Name)
                and node.func.id in ("tuple", "bool") and node.args):
            inner = _resolve_arg_expr(node.args[0])
            if inner and inner[1] is None:
                return inner[0], node.func.id
        # args.x.lower()
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "lower" and not node.args):
            inner = _resolve_arg_expr(node.func.value)
            if inner and inner[1] is None:
                return inner[0], "lower"
    return None


def config_mapping(mod: ModuleInfo,
                   func: str = "config_from_args") -> list[Mapping]:
    """Flatten the ``<Config>(field=args.dest, sub=SubConfig(...))``
    construction inside ``func`` into per-field mappings."""
    fn = next((n for n in ast.walk(mod.tree)
               if isinstance(n, ast.FunctionDef) and n.name == func), None)
    if fn is None:
        return []
    out: list[Mapping] = []

    def visit(call: ast.Call) -> None:
        cls = (dotted_name(call.func) or "").split(".")[-1]
        if not cls.endswith("Config"):
            return
        for kwarg in call.keywords:
            if kwarg.arg is None:
                continue
            if isinstance(kwarg.value, ast.Call):
                inner_cls = (dotted_name(kwarg.value.func) or "")
                if inner_cls.split(".")[-1].endswith("Config"):
                    visit(kwarg.value)
                    continue
            resolved = _resolve_arg_expr(kwarg.value)
            if resolved is not None:
                out.append(Mapping(cls=cls, field=kwarg.arg,
                                   dest=resolved[0], wrapper=resolved[1],
                                   lineno=kwarg.value.lineno))
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            cls = (dotted_name(node.func) or "").split(".")[-1]
            if cls.endswith("Config"):
                visit(node)
                break
    return out


def config_assigned_fields(mod: ModuleInfo,
                           func: str = "config_from_args"
                           ) -> dict[str, set[str]]:
    """Every keyword name passed to a ``*Config(...)`` construction in
    ``func``, keyed by class — broader than :func:`config_mapping`: a
    field assigned a computed (non-``args``) expression is still
    deliberately covered, it just is not default-comparable."""
    fn = next((n for n in ast.walk(mod.tree)
               if isinstance(n, ast.FunctionDef) and n.name == func), None)
    out: dict[str, set[str]] = {}
    if fn is None:
        return out
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        cls = (dotted_name(node.func) or "").split(".")[-1]
        if not cls.endswith("Config"):
            continue
        for kwarg in node.keywords:
            if kwarg.arg is not None:
                out.setdefault(cls, set()).add(kwarg.arg)
    return out


def apply_wrapper(value: Any, wrapper: str | None) -> Any:
    """The argparse default as the dataclass would receive it."""
    if value is UNEVAL:
        return UNEVAL
    try:
        if wrapper == "tuple":
            return tuple(value)
        if wrapper == "bool":
            return bool(value)
        if wrapper == "not":
            return not value
        if wrapper == "lower":
            return value.lower()
    except (TypeError, AttributeError):
        return UNEVAL
    return value


# ---------------------------------------------------------------------------
# metric names: declarations, uses, registrations
# ---------------------------------------------------------------------------

def names_table(mod: ModuleInfo) -> dict[str, tuple[str, int]]:
    """``CONST -> (value, lineno)`` for the module's top-level string
    assignments (the obs/names.py declaration table)."""
    out: dict[str, tuple[str, int]] = {}
    for stmt in mod.tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Constant)
                and isinstance(stmt.value.value, str)):
            out[stmt.targets[0].id] = (stmt.value.value, stmt.lineno)
    return out


def names_attr_uses(model: ProjectModel
                    ) -> list[tuple[str, str, int]]:
    """Every ``<names-alias>.CONST`` attribute access in the tree:
    ``(relpath, CONST, lineno)``. Covers rule manifests' builtin
    construction, /healthz blocks, bench plumbing — any consumer that
    spells a metric through the declared table."""
    uses: list[tuple[str, str, int]] = []
    for rel, mod in model.modules.items():
        local_names = {local for local, canon in mod.aliases.items()
                       if canon.endswith("obs.names")}
        if not local_names:
            continue
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in local_names):
                uses.append((rel, node.attr, node.lineno))
    return uses


@dataclasses.dataclass(frozen=True)
class Registration:
    """One ``obs.metrics.counter/gauge/histogram(<name>, ...)`` site."""

    relpath: str
    kind: str
    const: str | None      # names.CONST spelling, when used
    literal: str | None    # literal string spelling, when used
    lineno: int


_METRIC_FACTORIES = ("counter", "gauge", "histogram")


def metric_registrations(model: ProjectModel) -> list[Registration]:
    regs: list[Registration] = []
    for rel, mod in model.modules.items():
        metric_locals = {local for local, canon in mod.aliases.items()
                         if canon.endswith("obs.metrics")}
        names_locals = {local for local, canon in mod.aliases.items()
                        if canon.endswith("obs.names")}
        if not metric_locals:
            continue
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _METRIC_FACTORIES
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in metric_locals
                    and node.args):
                continue
            arg = node.args[0]
            const = literal = None
            if (isinstance(arg, ast.Attribute)
                    and isinstance(arg.value, ast.Name)
                    and arg.value.id in names_locals):
                const = arg.attr
            elif isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                literal = arg.value
            else:
                continue  # parameterized helpers register via their callers
            regs.append(Registration(relpath=rel, kind=node.func.attr,
                                     const=const, literal=literal,
                                     lineno=node.lineno))
    return regs


def string_literals(mod: ModuleInfo) -> Iterator[tuple[str, int]]:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value, node.lineno


# ---------------------------------------------------------------------------
# REASONS fallback table
# ---------------------------------------------------------------------------

def reasons_table(model: ProjectModel) -> dict[str, int]:
    """``key -> lineno`` of the engines/program.py REASONS literal."""
    mod = model.find("engines/program.py")
    if mod is None:
        return {}
    for stmt in mod.tree.body:
        target = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target = stmt.targets[0]
        elif isinstance(stmt, ast.AnnAssign):
            target = stmt.target
        if (isinstance(target, ast.Name) and target.id == "REASONS"
                and isinstance(stmt.value, ast.Dict)):
            return {k.value: k.lineno for k in stmt.value.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)}
    return {}


def reasons_span(model: ProjectModel) -> tuple[int, int]:
    """Line span of the REASONS table literal itself (so the orphan
    check does not count a key's own declaration as a use)."""
    mod = model.find("engines/program.py")
    if mod is None:
        return (0, 0)
    for stmt in mod.tree.body:
        target = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target = stmt.targets[0]
        elif isinstance(stmt, ast.AnnAssign):
            target = stmt.target
        if (isinstance(target, ast.Name) and target.id == "REASONS"
                and isinstance(stmt.value, ast.Dict)):
            return (stmt.lineno, stmt.end_lineno or stmt.lineno)
    return (0, 0)


def reason_key_uses(model: ProjectModel
                    ) -> list[tuple[str, str, int]]:
    """Literal reason-key uses: ``*_fallback_key`` returns plus literal
    arguments to ``report_fallback(engine, key)`` / ``reason(key)``.
    ``(relpath, key, lineno)``."""
    uses: list[tuple[str, str, int]] = []
    for rel, mod in model.modules.items():
        if rel.endswith("engines/program.py"):
            continue  # the table's own module declares, it cannot drift
        for node in ast.walk(mod.tree):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name.endswith("_fallback_key")):
                for sub in ast.walk(node):
                    if (isinstance(sub, ast.Return)
                            and isinstance(sub.value, ast.Constant)
                            and isinstance(sub.value.value, str)):
                        uses.append((rel, sub.value.value, sub.lineno))
            if isinstance(node, ast.Call):
                fname = (dotted_name(node.func) or "").split(".")[-1]
                key_arg = None
                if fname == "report_fallback" and len(node.args) >= 2:
                    key_arg = node.args[1]
                elif fname == "reason" and len(node.args) == 1:
                    key_arg = node.args[0]
                if (isinstance(key_arg, ast.Constant)
                        and isinstance(key_arg.value, str)):
                    uses.append((rel, key_arg.value, key_arg.lineno))
    return uses


# ---------------------------------------------------------------------------
# autotuner recipe keys vs committed recipes (tune/recipe.py)
# ---------------------------------------------------------------------------

def recipe_keys_table(model: ProjectModel
                      ) -> dict[str, tuple[str, int]]:
    """``cell key -> (CLI option, lineno)`` from the tune/recipe.py
    ``RECIPE_KEYS`` literal — the declared set of knobs a recipe may
    set."""
    mod = model.find("tune/recipe.py")
    if mod is None:
        return {}
    for stmt in mod.tree.body:
        target = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target = stmt.targets[0]
        elif isinstance(stmt, ast.AnnAssign):
            target = stmt.target
        if (isinstance(target, ast.Name) and target.id == "RECIPE_KEYS"
                and isinstance(stmt.value, ast.Dict)):
            out: dict[str, tuple[str, int]] = {}
            for k, v in zip(stmt.value.keys, stmt.value.values):
                if (isinstance(k, ast.Constant)
                        and isinstance(k.value, str)
                        and isinstance(v, ast.Constant)
                        and isinstance(v.value, str)):
                    out[k.value] = (v.value, k.lineno)
            return out
    return {}


def committed_recipes(model: ProjectModel) -> dict[str, Any]:
    """Every committed ``<package>/recipes/*.json`` parsed as JSON,
    keyed by file name; unparseable files map to None (the closure
    rule flags them — a committed recipe that does not parse would die
    at --recipe load time)."""
    rdir = os.path.join(model.root, model.package, "recipes")
    if not os.path.isdir(rdir):
        return {}
    out: dict[str, Any] = {}
    for fn in sorted(os.listdir(rdir)):
        if not fn.endswith(".json"):
            continue
        try:
            with open(os.path.join(rdir, fn), encoding="utf-8") as fh:
                out[fn] = json.load(fh)
        except (OSError, json.JSONDecodeError):
            out[fn] = None
    return out


# ---------------------------------------------------------------------------
# reflex-action registry (obs/actions.py BUILTIN_ACTIONS)
# ---------------------------------------------------------------------------

def actions_table(model: ProjectModel) -> dict[str, int]:
    """``action name -> lineno`` of the obs/actions.py
    ``BUILTIN_ACTIONS`` literal — the declared registry every rule
    ``action:`` binding must resolve into."""
    mod = model.find("obs/actions.py")
    if mod is None:
        return {}
    for stmt in mod.tree.body:
        target = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target = stmt.targets[0]
        elif isinstance(stmt, ast.AnnAssign):
            target = stmt.target
        if (isinstance(target, ast.Name)
                and target.id == "BUILTIN_ACTIONS"
                and isinstance(stmt.value, ast.Dict)):
            return {k.value: k.lineno for k in stmt.value.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)}
    return {}


def action_uses(model: ProjectModel) -> list[tuple[str, str, int, str]]:
    """Every literal action-name use across the package:
    ``(relpath, name, lineno, kind)`` with kind one of

    - ``rule``     — ``action="..."`` keyword on a ``HealthRule(...)``
                     call (the binding that makes a firing rule DO it)
    - ``dispatch`` — literal first argument to ``record_action(...)`` /
                     ``on_alert(...)`` (plane-initiated dispatches)
    - ``register`` — literal first argument to ``register(...)`` on the
                     bus (an engine/server realizing the action)

    Keyword matching is restricted to ``HealthRule`` calls so argparse
    ``action="store_true"`` keywords never read as reflex names."""
    uses: list[tuple[str, str, int, str]] = []
    for rel, mod in sorted(model.modules.items()):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else "")
            if name == "HealthRule":
                for kwarg in node.keywords:
                    if (kwarg.arg == "action"
                            and isinstance(kwarg.value, ast.Constant)
                            and isinstance(kwarg.value.value, str)
                            and kwarg.value.value):
                        uses.append((rel, kwarg.value.value,
                                     kwarg.value.lineno, "rule"))
            elif name in ("record_action", "on_alert", "register"):
                if (node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    kind = ("register" if name == "register"
                            else "dispatch")
                    uses.append((rel, node.args[0].value,
                                 node.args[0].lineno, kind))
    return uses


# ---------------------------------------------------------------------------
# startup-rejection sites -> compatibility-matrix rows
# ---------------------------------------------------------------------------

def _message_text(call: ast.Call) -> str:
    """The human message of an error/raise call: constant string parts
    concatenated (f-string holes dropped), whitespace collapsed."""
    parts: list[str] = []
    for node in ast.walk(call):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            parts.append(node.value)
    text = " ".join(" ".join(parts).split())
    return text[:140]


def _cond_attr_names(test: ast.AST, bases: tuple[str, ...],
                     aliases: dict[str, ast.AST] | None = None,
                     _seen: tuple[str, ...] = ()) -> set[str]:
    """Terminal attribute names read off the given bases (``args.x``,
    ``cfg.fed.x`` -> x) plus bare Names, inside a guard expression. A
    local alias of a base (``f = self.cfg.fed``; :func:`_local_aliases`)
    reads as the expression it names: ``f.x`` gives x, and ``f`` itself
    what ``self.cfg.fed`` gives."""
    aliases = aliases or {}
    roots = set(bases) | set(aliases)
    out: set[str] = set()
    for node in ast.walk(test):
        if isinstance(node, ast.Attribute):
            base = node.value
            while isinstance(base, ast.Attribute):
                base = base.value
            if isinstance(base, ast.Name) and base.id in roots:
                out.add(node.attr)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            out.add(node.id)
            if node.id in aliases and node.id not in _seen:
                out |= _cond_attr_names(aliases[node.id], bases, aliases,
                                        _seen + (node.id,))
    return out


#: the guard bases a rejection's knobs are read off
_GUARD_BASES = ("args", "self", "cfg", "config")
#: conversions an alias may wrap its attribute chain in
_ALIAS_WRAPPERS = ("float", "int", "bool", "str", "tuple")


def _rooted_chain(node: ast.AST, roots: set[str]) -> bool:
    """``node`` is an attribute chain ``a.b.c`` whose root names one of
    ``roots`` (a bare root Name does not count)."""
    if not isinstance(node, ast.Attribute):
        return False
    while isinstance(node, ast.Attribute):
        node = node.value
    return isinstance(node, ast.Name) and node.id in roots


def _local_aliases(fn: ast.AST) -> dict[str, ast.AST]:
    """A function's local aliases of the guard bases, in source order:
    ``name = <chain>`` or ``name = float(<chain>)`` (any of
    :data:`_ALIAS_WRAPPERS`), where the chain is rooted at a base or an
    earlier alias (``f = self.cfg.fed``; ``scale =
    float(cfg.loss_scale)``)."""
    aliases: dict[str, ast.AST] = {}
    assigns = sorted((n for n in ast.walk(fn) if isinstance(n, ast.Assign)
                      and len(n.targets) == 1
                      and isinstance(n.targets[0], ast.Name)),
                     key=lambda n: (n.lineno, n.col_offset))
    for node in assigns:
        value = node.value
        roots = set(_GUARD_BASES) | set(aliases)
        chain = value
        if (isinstance(value, ast.Call) and isinstance(value.func, ast.Name)
                and value.func.id in _ALIAS_WRAPPERS
                and len(value.args) == 1 and not value.keywords):
            chain = value.args[0]
        if _rooted_chain(chain, roots):
            aliases[node.targets[0].id] = value
    return aliases


def startup_validators(model: ProjectModel) -> set[tuple[str, str]]:
    """``(relpath, function)`` pairs of the tree's declared startup
    validators: the ``STARTUP_VALIDATORS`` tuple literal of
    ``"<relpath within the package>:<function>"`` strings in its
    ``config.py`` (empty when the tree declares none)."""
    cfg = model.module(f"{model.package}/config.py")
    if cfg is None:
        return set()
    for stmt in cfg.tree.body:
        target = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target = stmt.targets[0]
        elif isinstance(stmt, ast.AnnAssign):
            target = stmt.target
        if (isinstance(target, ast.Name)
                and target.id == "STARTUP_VALIDATORS"):
            spec = _literal(stmt.value)
            if not isinstance(spec, (tuple, list)):
                return set()
            out = set()
            for item in spec:
                if isinstance(item, str) and ":" in item:
                    rel, _, fn = item.rpartition(":")
                    out.add((f"{model.package}/{rel}", fn))
            return out
    return set()


def _enclosing_fn(node: ast.AST) -> ast.AST | None:
    fn = getattr(node, "_nidt_pparent", None)
    while fn is not None and not isinstance(
            fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        fn = getattr(fn, "_nidt_pparent", None)
    return fn


def _callee_name(call: ast.Call) -> str | None:
    """``f`` of ``f(...)`` and of ``self.f(...)``."""
    if isinstance(call.func, ast.Name):
        return call.func.id
    if (isinstance(call.func, ast.Attribute)
            and isinstance(call.func.value, ast.Name)
            and call.func.value.id == "self"):
        return call.func.attr
    return None


def _validator_knobs(mod: ModuleInfo, call: ast.AST, fn: ast.AST,
                     local: set[str]) -> set[str]:
    """The knobs of a rejection inside the declared validator ``fn``: its
    own guards with ``fn``'s aliases, and the guards around each call of
    ``fn`` from another declared validator of the module, with that
    caller's aliases (``_init_defended_round`` calls
    ``_init_secure_quant`` under ``if f.secure_quant:``)."""
    knobs: set[str] = set()
    aliases = _local_aliases(fn)
    for test in _enclosing_guards(call):
        knobs |= _cond_attr_names(test, _GUARD_BASES, aliases)
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call) and _callee_name(node) == fn.name):
            continue
        caller = _enclosing_fn(node)
        if caller is None or caller is fn or caller.name not in local:
            continue
        caller_aliases = _local_aliases(caller)
        for test in _enclosing_guards(node):
            knobs |= _cond_attr_names(test, _GUARD_BASES, caller_aliases)
    return knobs


def _annotate_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._nidt_pparent = node  # type: ignore[attr-defined]


def _enclosing_guards(node: ast.AST) -> Iterator[ast.AST]:
    cur = getattr(node, "_nidt_pparent", None)
    while cur is not None:
        if isinstance(cur, ast.If):
            yield cur.test
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        cur = getattr(cur, "_nidt_pparent", None)


def rejection_rows(model: ProjectModel,
                   knob_vocab: set[str]) -> list[dict[str, Any]]:
    """Compatibility-matrix rows extracted from startup-rejection
    sites: ``parser.error``/``ap.error`` calls in the CLIs, ``raise
    ValueError`` inside ``__init__`` bodies and inside the tree's
    declared startup validators (:func:`startup_validators`). A row
    qualifies when its guard reads >= 2 distinct knobs from the
    flag/config vocabulary — that is a *compatibility* rejection;
    single-knob range checks are plain validation and stay out of the
    matrix."""
    rows: list[dict[str, Any]] = []
    validators = startup_validators(model)
    for rel, mod in model.modules.items():
        _annotate_parents(mod.tree)
        local = {fn for where, fn in validators if where == rel}
        for node in ast.walk(mod.tree):
            call = None
            validator = None
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "error"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in ("parser", "ap")):
                call = node
            elif (isinstance(node, ast.Raise)
                    and isinstance(node.exc, ast.Call)
                    and (dotted_name(node.exc.func) or "")
                    .split(".")[-1] == "ValueError"):
                fn = _enclosing_fn(node)
                if fn is None:
                    continue
                if fn.name in local:
                    validator = fn
                elif fn.name != "__init__":
                    continue
                call = node.exc
            if call is None:
                continue
            knobs: set[str] = set()
            if validator is not None:
                knobs = _validator_knobs(mod, call, validator, local)
            else:
                for test in _enclosing_guards(call):
                    knobs |= _cond_attr_names(test, _GUARD_BASES)
            knobs &= knob_vocab
            if len(knobs) < 2:
                continue
            rows.append({
                "where": rel,
                "knobs": tuple(sorted(knobs)),
                "message": _message_text(call),
                # anchor for drift findings; stripped from the artifact
                "_line": call.lineno,
            })
    seen: set[tuple] = set()
    uniq = []
    for row in sorted(rows, key=lambda r: (r["where"], r["knobs"],
                                           r["message"])):
        key = (row["where"], row["knobs"], row["message"])
        if key not in seen:
            seen.add(key)
            uniq.append(row)
    return uniq


def knob_vocabulary(model: ProjectModel) -> set[str]:
    """Flag dests of both CLIs + every config dataclass field — the
    identifier set a matrix row's guard is read against."""
    vocab: set[str] = set()
    for suffix in ("/__main__.py", "distributed/run.py"):
        mod = model.find(suffix)
        if mod is not None:
            vocab |= set(argparse_flags(mod))
    cfg = model.find("/config.py")
    if cfg is not None:
        for fields in dataclass_fields(cfg).values():
            vocab |= set(fields)
    return vocab


# ---------------------------------------------------------------------------
# committed compat matrix artifact + markdown twin
# ---------------------------------------------------------------------------

#: the markdown twin of the matrix, relative to the package: a file the
#: port owns (the reference's twin is a block of its ARCHITECTURE.md)
TWIN = "analysis/COMPAT_MATRIX.md"

#: markers delimiting the generated table inside the twin
MD_BEGIN = "<!-- nidt:compat-matrix:begin (generated; do not edit) -->"
MD_END = "<!-- nidt:compat-matrix:end -->"

_MATRIX_HEADER = '''"""Generated compatibility matrix — DO NOT EDIT BY HAND.

Extracted from the tree's startup-rejection sites (``parser.error`` /
``ap.error`` in the CLIs, ``raise ValueError`` in ctors and in the
declared startup validators, ``config.py`` ``STARTUP_VALIDATORS``) by
the contract checker (analysis/contracts.py). Each row names WHERE the
rejection lives, WHICH knobs its guard reads, and the message — the
machine-readable twin of analysis/COMPAT_MATRIX.md's table.

Regenerate (also rewrites the COMPAT_MATRIX.md block)::

    python -m neuroimagedisttraining_tpu_torch.analysis --regen-compat

The project pass (``--project``) diffs this artifact against a fresh
extraction (``compat-matrix-drift``) and the markdown twin against
this artifact (``compat-matrix-doc-stale``), so a new startup rejection
without a regenerated matrix — or a hand-edited table — fails the
lint.
"""

from __future__ import annotations

from typing import Any

MATRIX: tuple[dict[str, Any], ...] = (
'''


def render_matrix_py(rows: list[dict[str, Any]]) -> str:
    out = [_MATRIX_HEADER]
    for row in rows:
        knobs = ", ".join(repr(k) for k in row["knobs"])
        if len(row["knobs"]) == 1:
            knobs += ","
        out.append("    {\n")
        out.append(f'        "where": {row["where"]!r},\n')
        out.append(f'        "knobs": ({knobs}),\n')
        out.append(f'        "message": (\n')
        msg = row["message"]
        if not msg:
            out.append('            ""),\n')
        for i in range(0, len(msg), 60):
            tail = "" if i + 60 < len(msg) else "),"
            out.append(f'            {msg[i:i + 60]!r}{tail}\n')
        out.append("    },\n")
    out.append(")\n")
    return "".join(out)


def render_matrix_md(rows: list[dict[str, Any]]) -> str:
    lines = [MD_BEGIN,
             "",
             "| where | knobs | rejection |",
             "|---|---|---|"]
    for row in rows:
        knobs = ", ".join(f"`{k}`" for k in row["knobs"])
        msg = row["message"].replace("|", "\\|")
        lines.append(f"| `{row['where']}` | {knobs} | {msg} |")
    lines += ["", MD_END]
    return "\n".join(lines)


def committed_matrix(model: ProjectModel) -> list[dict[str, Any]] | None:
    """The MATRIX literal parsed from the committed artifact's source
    (never imported — the checker must not execute the file it is
    judging). None when the artifact does not exist yet."""
    mod = model.find("analysis/compat_matrix.py")
    if mod is None:
        return None
    for stmt in mod.tree.body:
        target = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target = stmt.targets[0]
        elif isinstance(stmt, ast.AnnAssign):
            target = stmt.target
        if isinstance(target, ast.Name) and target.id == "MATRIX":
            try:
                rows = ast.literal_eval(stmt.value)
            except (ValueError, SyntaxError):
                return None
            return [dict(r, knobs=tuple(r.get("knobs", ())))
                    for r in rows]
    return None


def twin_relpath(package: str) -> str:
    """The markdown twin's path relative to the root (findings' path)."""
    return f"{package}/{TWIN}"


def doc_matrix_block(model: ProjectModel
                     ) -> tuple[str | None, int]:
    """(block text between the markers, begin-marker line) from the
    package's markdown twin (:data:`TWIN`); (None, 0) when absent."""
    path = os.path.join(model.root, twin_relpath(model.package))
    if not os.path.exists(path):
        return None, 0
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    begin = text.find(MD_BEGIN)
    end = text.find(MD_END)
    if begin < 0 or end < 0 or end < begin:
        return None, 0
    line = text[:begin].count("\n") + 1
    return text[begin:end + len(MD_END)], line


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def default_root() -> tuple[str, str]:
    """(repo root, package name) inferred from this file's location."""
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg_dir), os.path.basename(pkg_dir)


def lint_project(root: str | None = None, package: str | None = None,
                 rules: Iterable[str] | None = None) -> list[Finding]:
    """Run every registered :class:`ProjectRule` over the cross-file
    model. Findings anchored in a parsed module honor that module's
    ``# nidt: allow[...]`` pragmas exactly like per-file findings."""
    if root is None or package is None:
        d_root, d_pkg = default_root()
        root = root or d_root
        package = package or d_pkg
    model = build_model(root, package)
    findings: list[Finding] = []
    for rule in _selected_rules(rules):
        if isinstance(rule, ProjectRule):
            findings.extend(rule.project_check(model))
    if rules is not None:
        wanted = set(rules)
        findings = [f for f in findings if f.rule in wanted]
    out: list[Finding] = []
    by_path: dict[str, list[Finding]] = {}
    for f in findings:
        by_path.setdefault(f.path, []).append(f)
    for path, fs in by_path.items():
        mod = model.modules.get(path)
        if mod is None:
            out.extend(fs)
        else:
            out.extend(_apply_suppressions(mod, fs))
    return sorted(out, key=lambda f: (f.path, f.line, f.rule, f.message))


def regen_compat(root: str | None = None,
                 package: str | None = None) -> tuple[str, str]:
    """Regenerate the committed matrix artifact and the markdown twin's
    block (:data:`TWIN`; text outside the markers is kept) from a fresh
    extraction; returns the two paths written."""
    if root is None or package is None:
        d_root, d_pkg = default_root()
        root = root or d_root
        package = package or d_pkg
    model = build_model(root, package)
    rows = rejection_rows(model, knob_vocabulary(model))
    py_path = os.path.join(root, package, "analysis", "compat_matrix.py")
    os.makedirs(os.path.dirname(py_path), exist_ok=True)
    with open(py_path, "w", encoding="utf-8") as fh:
        fh.write(render_matrix_py(rows))
    md_path = os.path.join(root, twin_relpath(package))
    block = render_matrix_md(rows)
    if os.path.exists(md_path):
        with open(md_path, encoding="utf-8") as fh:
            text = fh.read()
        begin = text.find(MD_BEGIN)
        end = text.find(MD_END)
        if begin >= 0 and end > begin:
            text = text[:begin] + block + text[end + len(MD_END):]
        else:
            text = text.rstrip("\n") + "\n\n" + block + "\n"
        with open(md_path, "w", encoding="utf-8") as fh:
            fh.write(text)
    else:
        with open(md_path, "w", encoding="utf-8") as fh:
            fh.write(block + "\n")
    return py_path, md_path

