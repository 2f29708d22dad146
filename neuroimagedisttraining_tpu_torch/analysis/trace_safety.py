"""Trace-safety rules: no host syncs or numpy draws inside a captured step
(the reference package's ``analysis/trace_safety.py``).

A local step runs as a CUDA graph (``core/graphs.py`` ``StepGraph``): the
step function runs eagerly once, is captured once and is replayed after
that. A ``.item()``, ``.cpu()`` or ``torch.cuda.synchronize`` there syncs
the host with the card in the eager step and fails the capture (a sync
is illegal while a stream captures), and ``np.random.*`` draws ONE value
at capture that every replay reuses: the graph bakes it in, as the
reference's jitted executable bakes a traced draw. The rule marks as a
captured step

- a function handed to ``StepGraph(...)`` as its ``body`` (first
  positional argument or ``body=``) — resolved lexically: a local
  ``def`` by enclosing-scope name lookup, a method by ``self.<name>``
  within the class, a lambda in place;
- the body of a ``with torch.cuda.graph(...)`` block (what it captures);
- a function CALLED from a captured step by a lexically resolvable name
  (bare name, ``self.<name>``, or ``<alias>.<name>`` where the function
  set ``alias = self`` or ``alias = weakref.proxy(self)``), transitively
  — the capture does not stop at a call boundary. Foreign attributes
  (``module.fn``, ``self.model(...)``) lint in their own file,

and then flags, anywhere lexically inside it:

- ``trace-host-sync``: ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``float()`` / ``int()`` / ``bool()`` of a value that is
  not a literal, and ``torch.cuda.synchronize``;
- ``trace-np-random``: ``np.random.*``.

Calls *of* a captured step, and host code that reads its outputs after
the replay, are not flagged. :func:`collect_traced` is the resolver the
obs and precision families reuse.
"""

from __future__ import annotations

import ast
from typing import Iterator

from neuroimagedisttraining_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Rule,
    dotted_name,
    normalize,
    register,
)

#: the capture entry points by the last part of their dotted name:
#: ``StepGraph(body, ...)`` (positional index 0 or ``body=``)
CAPTURERS: dict[str, tuple[int, str]] = {"StepGraph": (0, "body")}
#: context managers whose block is captured
CAPTURE_BLOCKS = {"torch.cuda.graph"}
#: a call whose result stands for ``self`` where a local name is bound to
#: it (``tr = weakref.proxy(self)``)
_SELF_WRAPPERS = {"weakref.proxy"}

#: host-synchronizing calls by canonical dotted name
HOST_SYNC_DOTTED = {"torch.cuda.synchronize"}
#: host-synchronizing zero-argument methods of a tensor
HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
#: Python scalar conversions, a sync when given a tensor
HOST_SYNC_BUILTINS = {"float", "int", "bool"}

_SCOPES = (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
           ast.ClassDef)
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _annotate_parents(tree: ast.Module) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._nidt_parent = node  # type: ignore[attr-defined]


def _ancestors(node: ast.AST) -> Iterator[ast.AST]:
    cur = getattr(node, "_nidt_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_nidt_parent", None)


class _DefIndex:
    """Lexical lookup of function definitions: ``(scope, name) -> def``."""

    def __init__(self, tree: ast.Module):
        self._by_scope: dict[tuple[int, str], ast.AST] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope = self._enclosing_scope(node)
                self._by_scope[(id(scope), node.name)] = node

    @staticmethod
    def _enclosing_scope(node: ast.AST) -> ast.AST:
        for anc in _ancestors(node):
            if isinstance(anc, _SCOPES):
                return anc
        return node

    def resolve_name(self, at: ast.AST, name: str) -> ast.AST | None:
        """Innermost-scope-first lookup of ``name`` from ``at``'s position."""
        for anc in _ancestors(at):
            if isinstance(anc, _SCOPES):
                hit = self._by_scope.get((id(anc), name))
                if hit is not None:
                    return hit
        return None

    def resolve_method(self, at: ast.AST, name: str) -> ast.AST | None:
        for anc in _ancestors(at):
            if isinstance(anc, ast.ClassDef):
                return self._by_scope.get((id(anc), name))
        return None


def _self_aliases(at: ast.AST, aliases: dict[str, str]) -> set[str]:
    """The names that stand for ``self`` at ``at``: ``self`` and ``cls``,
    and every local of an enclosing function bound to ``self`` or to
    ``weakref.proxy(self)``."""
    names = {"self", "cls"}
    for anc in _ancestors(at):
        if not isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(anc):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            v = node.value
            if isinstance(v, ast.Call) and normalize(
                    dotted_name(v.func), aliases) in _SELF_WRAPPERS \
                    and v.args:
                v = v.args[0]
            if isinstance(v, ast.Name) and v.id == "self":
                names.add(node.targets[0].id)
    return names


def _is_capturer(node: ast.Call, aliases: dict[str, str]
                 ) -> tuple[int, str] | None:
    name = normalize(dotted_name(node.func), aliases) or ""
    return CAPTURERS.get(name.split(".")[-1])


def collect_traced(mod: ModuleInfo) -> list[ast.AST]:
    """Every captured step of this module: the function and lambda nodes
    handed to a capturer, the ``with`` blocks that capture, and their
    lexically resolvable callees."""
    _annotate_parents(mod.tree)
    index = _DefIndex(mod.tree)
    aliases = mod.aliases
    traced: dict[int, ast.AST] = {}

    def mark(node: ast.AST | None) -> None:
        if isinstance(node, (*_FUNCS, ast.With, ast.AsyncWith)):
            traced[id(node)] = node

    def resolve(at: ast.AST, target: ast.AST) -> ast.AST | None:
        if isinstance(target, ast.Lambda):
            return target
        if isinstance(target, ast.Name):
            return index.resolve_name(at, target.id)
        if (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id in _self_aliases(at, aliases)):
            return index.resolve_method(at, target.attr)
        return None  # a foreign attribute lints in its own file

    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(it.context_expr, ast.Call)
                and normalize(dotted_name(it.context_expr.func), aliases)
                in CAPTURE_BLOCKS for it in node.items):
            mark(node)
        if not isinstance(node, ast.Call):
            continue
        spec = _is_capturer(node, aliases)
        if spec is None:
            continue
        idx, kw = spec
        target = node.args[idx] if idx < len(node.args) else next(
            (k.value for k in node.keywords if k.arg == kw), None)
        if target is not None:
            mark(resolve(node, target))

    # the transitive closure: a call from inside a captured step to a
    # lexically resolvable function runs that function under the capture
    work = list(traced.values())
    while work:
        root = work.pop()
        for node in ast.walk(root):
            if not isinstance(node, ast.Call):
                continue
            callee = resolve(node, node.func)
            if isinstance(callee, _FUNCS) and id(callee) not in traced:
                traced[id(callee)] = callee
                work.append(callee)
    return list(traced.values())


def calls_in_captured(mod: ModuleInfo) -> Iterator[ast.Call]:
    """Each call lexically inside a captured step, once."""
    seen: set[int] = set()
    for root in collect_traced(mod):
        for node in ast.walk(root):
            if id(node) in seen or not isinstance(node, ast.Call):
                continue
            seen.add(id(node))
            yield node


@register
class TraceSafetyRule(Rule):
    rule_ids = ("trace-host-sync", "trace-np-random")
    description = ("no .item()/.tolist()/.cpu()/.numpy()/float()/int()/"
                   "bool()/torch.cuda.synchronize (trace-host-sync) or "
                   "np.random.* (trace-np-random) lexically inside a "
                   "captured step (a StepGraph body, a torch.cuda.graph "
                   "block, and their resolvable callees)")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for node in calls_in_captured(mod):
            yield from self._check_call(mod, node)

    def _check_call(self, mod: ModuleInfo,
                    node: ast.Call) -> Iterator[Finding]:
        func = node.func
        if (isinstance(func, ast.Name) and func.id in HOST_SYNC_BUILTINS
                and len(node.args) == 1
                and not isinstance(node.args[0], ast.Constant)):
            yield Finding(mod.path, node.lineno, "trace-host-sync",
                          f"{func.id}() of a tensor inside a captured step "
                          "syncs the host with the card (illegal while the "
                          "graph captures)")
            return
        if (isinstance(func, ast.Attribute)
                and func.attr in HOST_SYNC_METHODS and not node.args):
            yield Finding(mod.path, node.lineno, "trace-host-sync",
                          f".{func.attr}() forces a host sync inside a "
                          "captured step")
            return
        name = normalize(dotted_name(func), mod.aliases)
        if name in HOST_SYNC_DOTTED:
            yield Finding(mod.path, node.lineno, "trace-host-sync",
                          f"{name} inside a captured step waits for the "
                          "card (illegal while the graph captures)")
        elif name is not None and name.startswith("numpy.random."):
            yield Finding(mod.path, node.lineno, "trace-np-random",
                          f"{name} inside a captured step draws once at "
                          "capture; every replay reuses that draw")


__all__ = ["TraceSafetyRule", "collect_traced", "calls_in_captured",
           "CAPTURERS", "CAPTURE_BLOCKS", "HOST_SYNC_DOTTED",
           "HOST_SYNC_METHODS"]
