"""nidtlint core (the reference package's ``analysis/core.py``): findings,
suppression pragmas, the rule registry, the drivers.

The linter is dependency-free (stdlib ``ast`` + ``tokenize`` only) so it
can run as a tier-1 gate wherever the port runs, with no ``torch`` import.

Suppression: append ``# nidt: allow[rule-id] -- one-line justification``
to any line of the offending simple statement (findings anchored on a
``class``/``def``/``with`` header take the pragma on exactly that line).
The justification is mandatory — a bare pragma is itself a finding (rule
``pragma``), so every suppressed invariant in the tree carries its reason
next to it. Multiple ids may be listed:
``allow[metric-orphan, reason-orphan]``.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import os
import re
import tokenize
from typing import Iterable, Iterator

_PRAGMA_RE = re.compile(
    r"#\s*nidt:\s*allow\[(?P<ids>[^\]]*)\]\s*(?:(?:--+|[:–—])\s*"
    r"(?P<why>\S.*))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at ``path:line``."""

    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"

    def as_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Pragma:
    """A parsed ``# nidt: allow[...]`` comment."""

    line: int
    rule_ids: tuple[str, ...]
    justification: str


@dataclasses.dataclass
class ModuleInfo:
    """Everything a rule needs about one source file."""

    path: str
    source: str
    tree: ast.Module
    pragmas: dict[int, Pragma]
    aliases: dict[str, str]  # local name -> canonical dotted module path

    @property
    def path_parts(self) -> tuple[str, ...]:
        return tuple(os.path.normpath(self.path).split(os.sep))


class Rule:
    """Base class for a rule family. Subclasses are registered with
    :func:`register` and emit :class:`Finding` objects from ``check``."""

    #: every rule id this family can emit (used by --rules and --list-rules)
    rule_ids: tuple[str, ...] = ()
    description: str = ""

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        raise NotImplementedError


RULE_REGISTRY: dict[str, type[Rule]] = {}


def register(cls: type[Rule]) -> type[Rule]:
    """Class decorator: add a rule family to the registry (keyed by its
    first rule id; all ids must be unique across families)."""
    for rid in cls.rule_ids:
        for other in RULE_REGISTRY.values():
            if other is not cls and rid in other.rule_ids:
                raise ValueError(f"duplicate rule id {rid!r}")
    RULE_REGISTRY[cls.rule_ids[0]] = cls
    return cls


def all_rule_ids() -> list[str]:
    return sorted(rid for cls in RULE_REGISTRY.values() for rid in cls.rule_ids)


# ---------- dotted-name helpers shared by every rule ----------

def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def collect_aliases(tree: ast.Module) -> dict[str, str]:
    """Map local import names to canonical dotted paths, so rules can
    recognize ``np.random.seed`` however numpy was imported."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def normalize(name: str | None, aliases: dict[str, str]) -> str | None:
    """Rewrite the leading component of a dotted name through the module's
    import aliases (``np.random.seed`` -> ``numpy.random.seed``)."""
    if name is None:
        return None
    head, _, rest = name.partition(".")
    head = aliases.get(head, head)
    return f"{head}.{rest}" if rest else head


# ---------- pragma parsing ----------

def parse_pragmas(source: str) -> dict[int, Pragma]:
    pragmas: dict[int, Pragma] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [(t.start[0], t.string) for t in tokens
                    if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, SyntaxError, IndentationError):
        comments = [(i + 1, line[line.index("#"):])
                    for i, line in enumerate(source.splitlines())
                    if "#" in line]
    for line, text in comments:
        m = _PRAGMA_RE.search(text)
        if not m:
            continue
        ids = tuple(s.strip() for s in m.group("ids").split(",") if s.strip())
        pragmas[line] = Pragma(line=line, rule_ids=ids,
                               justification=(m.group("why") or "").strip())
    return pragmas


class _PragmaRule(Rule):
    """Meta rule: every pragma must name known rule ids AND carry a
    one-line justification. Pragma findings are never suppressible —
    otherwise a pragma could excuse itself."""

    rule_ids = ("pragma",)
    description = ("`# nidt: allow[...]` pragmas must list known rule ids "
                   "and end with `-- <one-line justification>`")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        known = set(all_rule_ids())
        for p in mod.pragmas.values():
            if not p.rule_ids:
                yield Finding(mod.path, p.line, "pragma",
                              "empty allow[] — name the rule ids to suppress")
            for rid in p.rule_ids:
                if rid not in known:
                    yield Finding(mod.path, p.line, "pragma",
                                  f"unknown rule id {rid!r} in allow[]")
            if not p.justification:
                yield Finding(
                    mod.path, p.line, "pragma",
                    "missing justification — write `# nidt: allow[id] -- "
                    "why this violation is intentional`")


register(_PragmaRule)


# ---------- drivers ----------

def _selected_rules(rules: Iterable[str] | None) -> list[Rule]:
    if rules is None:
        return [cls() for cls in RULE_REGISTRY.values()]
    wanted = set(rules)
    unknown = wanted - set(all_rule_ids())
    if unknown:
        raise ValueError(f"unknown rule ids: {sorted(unknown)}")
    picked = [cls for cls in RULE_REGISTRY.values()
              if wanted & set(cls.rule_ids)]
    if _PragmaRule not in picked:
        picked.append(_PragmaRule)  # the meta rule always runs
    return [cls() for cls in picked]


def lint_source(source: str, path: str = "<string>",
                rules: Iterable[str] | None = None) -> list[Finding]:
    """Lint one source blob; ``path`` is the findings' path (and drives
    the path-scoped rule families, where there are any)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 1, "parse-error",
                        f"could not parse: {e.msg}")]
    mod = ModuleInfo(path=path, source=source, tree=tree,
                     pragmas=parse_pragmas(source),
                     aliases=collect_aliases(tree))
    findings: list[Finding] = []
    for rule in _selected_rules(rules):
        findings.extend(rule.check(mod))
    if rules is not None:
        # a family can emit several ids — honor the id-level selection
        # (the pragma meta rule always reports)
        wanted = set(rules) | {"pragma", "parse-error"}
        findings = [f for f in findings if f.rule in wanted]
    return sorted(_apply_suppressions(mod, findings),
                  key=lambda f: (f.line, f.rule, f.message))


#: compound statements own whole bodies — a pragma anywhere inside one
#: must NOT suppress a finding anchored on its header line
_COMPOUND = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.If,
             ast.For, ast.AsyncFor, ast.While, ast.With, ast.AsyncWith,
             ast.Try)


def _apply_suppressions(mod: ModuleInfo,
                        findings: list[Finding]) -> list[Finding]:
    """Drop findings covered by an allow pragma on any line of the SIMPLE
    statement containing them (so a pragma fits naturally on either the
    opening line or the close-paren line of a multi-line call). Findings
    anchored on a compound header (class/def/with/... line) accept a
    pragma on exactly that line — a pragma buried in the body must never
    excuse a class-level contract finding. Justified pragmas only in
    spirit: a bare pragma still suppresses, but the `pragma` meta finding
    it raised is never suppressible, so the tree cannot go green without
    the reason being recorded."""
    simple_spans: list[tuple[int, int]] = [
        (node.lineno, node.end_lineno)
        for node in ast.walk(mod.tree)
        if isinstance(node, ast.stmt)
        and not isinstance(node, _COMPOUND)
        and node.end_lineno is not None]
    out = []
    for f in findings:
        if f.rule == "pragma":
            out.append(f)
            continue
        containing = [s for s in simple_spans if s[0] <= f.line <= s[1]]
        if containing:
            start, end = min(containing, key=lambda s: s[1] - s[0])
            span = range(start, end + 1)
        else:  # compound header: the pragma must sit on the flagged line
            span = range(f.line, f.line + 1)
        if any(f.rule in mod.pragmas[ln].rule_ids
               for ln in span if ln in mod.pragmas):
            continue
        out.append(f)
    return out


def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith(".")
                                 and d != "__pycache__")
                for fn in sorted(files):
                    if fn.endswith(".py"):
                        yield os.path.join(root, fn)
        else:
            raise FileNotFoundError(p)


_RULES_VERSION: str | None = None


def _rules_version() -> str:
    """Content hash of every module in analysis/ — a rule edit must
    invalidate the whole finding cache, not just rerun changed files."""
    global _RULES_VERSION
    if _RULES_VERSION is None:
        h = hashlib.sha256()
        here = os.path.dirname(os.path.abspath(__file__))
        for root, dirs, files in os.walk(here):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            for fn in sorted(files):
                if fn.endswith(".py"):
                    with open(os.path.join(root, fn), "rb") as fh:
                        h.update(fn.encode())
                        h.update(fh.read())
        _RULES_VERSION = h.hexdigest()
    return _RULES_VERSION


def _cache_key(path: str, source: str,
               rules: Iterable[str] | None) -> str:
    h = hashlib.sha256()
    h.update(_rules_version().encode())
    h.update(b"\0")
    h.update((",".join(sorted(rules)) if rules is not None else "*")
             .encode())
    h.update(b"\0")
    h.update(path.encode())
    h.update(b"\0")
    h.update(source.encode())
    return h.hexdigest()


def lint_paths(paths: Iterable[str],
               rules: Iterable[str] | None = None,
               cache_dir: str | None = None) -> list[Finding]:
    """Lint every ``.py`` under ``paths``. With ``cache_dir``, per-file
    findings are memoized by content hash (key covers the source bytes,
    the rule selection AND a hash of analysis/ itself, so editing a rule
    invalidates everything); a hit skips the parse entirely. The cache
    holds FINDINGS, not verdicts — a hit replays identical output."""
    findings: list[Finding] = []
    for fp in iter_py_files(paths):
        with open(fp, encoding="utf-8") as fh:
            source = fh.read()
        if cache_dir is not None:
            key = _cache_key(fp, source, rules)
            cpath = os.path.join(cache_dir, key + ".json")
            try:
                with open(cpath, encoding="utf-8") as fh:
                    findings.extend(Finding(**d) for d in json.load(fh))
                continue
            except (OSError, json.JSONDecodeError, TypeError):
                pass  # miss or corrupt entry: lint and rewrite
        file_findings = lint_source(source, path=fp, rules=rules)
        findings.extend(file_findings)
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = cpath + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump([f.as_json() for f in file_findings], fh)
            os.replace(tmp, cpath)
    return findings
