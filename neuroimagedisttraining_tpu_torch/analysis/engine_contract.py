"""Engine-contract rules: every ``FederatedEngine`` subclass keeps the
round contract that ``__main__``/``create_engine`` rely on (the reference
package's ``analysis/engine_contract.py``).

Checked per class (ancestry resolved lexically through the file's own
classes plus sibling files in the same directory, so ``FedProxEngine
(FedAvgEngine)`` is recognized as an engine):

- ``engine-attrs``   — ``name`` must be declared in the class's OWN body
  (inheriting it would collide in the ``ENGINES`` registry). The
  reference also requires ``supports_streaming``; the port's engines all
  stream, and its ``FederatedEngine`` has no such switch to fall through
  to.
- ``engine-round``   — the required round method ``train`` must be defined
  on the class or a non-root ancestor (the root only raises).
- ``engine-signature`` — any override of a ``FederatedEngine`` method must
  keep the base positional signature (extra trailing params need
  defaults), so engines stay drop-in interchangeable.

Reference signatures come from ``engines/base.py`` next to the linted
file when present, falling back to the packaged one — fixtures in a temp
directory are checked against the real contract.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterator

from neuroimagedisttraining_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Rule,
    dotted_name,
    register,
)

ROOT_CLASS = "FederatedEngine"
REQUIRED_OWN_ATTRS = ("name",)
REQUIRED_ROUND_METHODS = ("train",)

#: (positional arg names, #defaults, has *args, has **kwargs)
_Sig = tuple[tuple[str, ...], int, bool, bool]


@dataclasses.dataclass
class _ClassInfo:
    name: str
    bases: tuple[str, ...]
    attrs: set[str]
    methods: dict[str, _Sig]
    method_lines: dict[str, int]
    lineno: int


def _signature(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> _Sig:
    a = fn.args
    names = tuple(p.arg for p in (*a.posonlyargs, *a.args))
    return (names, len(a.defaults), a.vararg is not None,
            a.kwarg is not None)


def _classes_of(tree: ast.Module) -> dict[str, _ClassInfo]:
    out: dict[str, _ClassInfo] = {}
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        attrs: set[str] = set()
        methods: dict[str, _Sig] = {}
        lines: dict[str, int] = {}
        for stmt in node.body:
            if isinstance(stmt, ast.Assign):
                attrs.update(t.id for t in stmt.targets
                             if isinstance(t, ast.Name))
            elif isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name):
                attrs.add(stmt.target.id)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                methods[stmt.name] = _signature(stmt)
                lines[stmt.name] = stmt.lineno
        bases = tuple(n.split(".")[-1] for n in
                      (dotted_name(b) for b in node.bases) if n)
        out[node.name] = _ClassInfo(node.name, bases, attrs, methods,
                                    lines, node.lineno)
    return out


_PACKAGED_BASE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "engines", "base.py")
_dir_cache: dict[str, dict[str, _ClassInfo]] = {}


def _parse_file(path: str) -> dict[str, _ClassInfo]:
    try:
        with open(path, encoding="utf-8") as fh:
            return _classes_of(ast.parse(fh.read(), filename=path))
    except (OSError, SyntaxError):
        return {}


def _sibling_classes(path: str) -> dict[str, _ClassInfo]:
    """Classes from every other .py in the linted file's directory."""
    d = os.path.dirname(os.path.abspath(path))
    if d not in _dir_cache:
        table: dict[str, _ClassInfo] = {}
        if os.path.isdir(d):
            for fn in sorted(os.listdir(d)):
                if fn.endswith(".py"):
                    table.update(_parse_file(os.path.join(d, fn)))
        _dir_cache[d] = table
    table = dict(_dir_cache[d])
    return table


@register
class EngineContractRule(Rule):
    rule_ids = ("engine-attrs", "engine-round", "engine-signature")
    description = ("FederatedEngine subclasses declare name, define the "
                   "round method train, and keep base-method signatures "
                   "from engines/base.py")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        table = _sibling_classes(mod.path)
        table.update(_classes_of(mod.tree))  # the in-memory source wins
        if ROOT_CLASS not in table:
            table.update(_parse_file(_PACKAGED_BASE))
        base = table.get(ROOT_CLASS)
        for info in _classes_of(mod.tree).values():
            if info.name == ROOT_CLASS:
                continue
            chain = self._engine_ancestry(info, table)
            if chain is None:
                continue
            yield from self._check_class(mod, info, chain, base)

    @staticmethod
    def _engine_ancestry(info: _ClassInfo,
                         table: dict[str, _ClassInfo]
                         ) -> list[_ClassInfo] | None:
        """Non-root ancestors (nearest first) if ``info`` reaches
        ``FederatedEngine``; None when it is not an engine class."""
        chain: list[_ClassInfo] = []
        seen = {info.name}
        frontier = list(info.bases)
        reached = False
        while frontier:
            b = frontier.pop(0)
            if b == ROOT_CLASS:
                reached = True
                continue
            anc = table.get(b)
            if anc is None or anc.name in seen:
                continue
            seen.add(anc.name)
            chain.append(anc)
            frontier.extend(anc.bases)
        return chain if reached else None

    def _check_class(self, mod: ModuleInfo, info: _ClassInfo,
                     ancestors: list[_ClassInfo],
                     base: _ClassInfo | None) -> Iterator[Finding]:
        for attr in REQUIRED_OWN_ATTRS:
            if attr not in info.attrs:
                yield Finding(
                    mod.path, info.lineno, "engine-attrs",
                    f"engine class {info.name} must declare the class attr "
                    f"{attr!r} in its own body (an inherited value would "
                    "collide in the ENGINES registry)")
        defined = set(info.methods).union(*(a.methods for a in ancestors),
                                          set())
        for meth in REQUIRED_ROUND_METHODS:
            if meth not in defined:
                yield Finding(
                    mod.path, info.lineno, "engine-round",
                    f"engine class {info.name} must define the round "
                    f"method {meth}() (the FederatedEngine base only "
                    "raises NotImplementedError)")
        if base is not None:
            yield from self._check_signatures(mod, info, base)

    @staticmethod
    def _check_signatures(mod: ModuleInfo, info: _ClassInfo,
                          base: _ClassInfo) -> Iterator[Finding]:
        for meth, sig in info.methods.items():
            ref = base.methods.get(meth)
            if ref is None:
                continue
            names, n_defaults, has_var, _ = sig
            ref_names = ref[0]
            # a *args override may absorb the tail of the base signature
            prefix_ok = (names[:len(ref_names)] == ref_names
                         or (has_var and ref_names[:len(names)] == names))
            extras = names[len(ref_names):]
            extras_defaulted = len(extras) <= n_defaults
            if not prefix_ok or (extras and not extras_defaulted
                                 and not has_var):
                yield Finding(
                    mod.path, info.method_lines[meth], "engine-signature",
                    f"{info.name}.{meth}{tuple(names)!r} does not match "
                    f"the FederatedEngine contract {meth}"
                    f"{tuple(ref_names)!r} from engines/base.py (extra "
                    "params must be trailing with defaults)")
