"""Shared-memory lifecycle rules for the partial hand-off slabs.

POSIX shared memory outlives the process that maps it: a segment is a
named kernel object that dies only when someone calls ``unlink()`` (and
every mapping is ``close()``d). The hierarchical ingest tier
(asyncfl/ingest.py ``_ShmSlabWriter``/``_ShmSlabReader``)
splits the lifecycle across processes — the worker OWNS its slabs, the
parent only ATTACHES — so the teardown rules are asymmetric and a mixed-
up call site leaks segments under ``/dev/shm`` run after run, or worse,
yanks a segment out from under a peer that still maps it:

- ``shm-owner-teardown`` — a class that creates a segment
  (``SharedMemory(..., create=True)``) must, somewhere in the class,
  call BOTH ``.close()`` (drop its own mapping) and ``.unlink()``
  (destroy the name). Missing unlink leaks the segment past process
  exit; missing close leaks the mapping (and trips BufferError on
  interpreter teardown when numpy views are still live).
- ``shm-attach-unlink`` — a class that only attaches
  (``SharedMemory(name)`` without ``create=True``) must NEVER call
  ``.unlink()``: destroying a name the attacher does not own races the
  owner's own teardown and invalidates the discipline that exactly one
  process is responsible for the segment's lifetime.

The rule is lexical and CLASS-scoped (module-level functions form their
own scope): presence of the teardown calls anywhere in the owning class
satisfies it — whether they actually run on every path is the runtime
tests' job (tests/test_torch_region.py drives real slabs through writer
and reader teardown), not an AST question.
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


def _is_shared_memory_ctor(call: ast.Call, aliases: dict) -> bool:
    name = normalize(dotted_name(call.func), aliases)
    return name is not None and (
        name == "SharedMemory"
        or name.endswith("shared_memory.SharedMemory"))


def _is_create(call: ast.Call) -> bool:
    """``SharedMemory(..., create=True)`` — keyword or the second
    positional argument (``SharedMemory(name, True, size)``)."""
    for kwarg in call.keywords:
        if kwarg.arg == "create":
            return isinstance(kwarg.value, ast.Constant) \
                and bool(kwarg.value.value)
    if len(call.args) >= 2:
        return isinstance(call.args[1], ast.Constant) \
            and bool(call.args[1].value)
    return False


class _ScopeUse:
    """What one class (or module-level function) does with shm."""

    def __init__(self) -> None:
        self.creates: list[ast.Call] = []
        self.attaches: list[ast.Call] = []
        self.closes = False
        self.unlinks: list[ast.Call] = []


def _scan_scope(scope: ast.AST, aliases: dict) -> _ScopeUse:
    use = _ScopeUse()
    for node in ast.walk(scope):
        if not isinstance(node, ast.Call):
            continue
        if _is_shared_memory_ctor(node, aliases):
            (use.creates if _is_create(node)
             else use.attaches).append(node)
        elif isinstance(node.func, ast.Attribute):
            if node.func.attr == "close":
                use.closes = True
            elif node.func.attr == "unlink":
                use.unlinks.append(node)
    return use


@register
class ShmDisciplineRule(Rule):
    rule_ids = ("shm-owner-teardown", "shm-attach-unlink")
    description = ("a class creating SharedMemory(create=True) must "
                   "call both .close() and .unlink(); an attach-only "
                   "class must never .unlink() a segment it does not "
                   "own")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for scope in self._scopes(mod.tree):
            use = _scan_scope(scope, mod.aliases)
            if use.creates:
                has_unlink = bool(use.unlinks)
                for call in use.creates:
                    if not use.closes:
                        yield Finding(
                            mod.path, call.lineno, "shm-owner-teardown",
                            f"{self._label(scope)} creates a shared-"
                            "memory segment but never calls .close() — "
                            "the owner must drop its own mapping "
                            "before unlinking")
                    if not has_unlink:
                        yield Finding(
                            mod.path, call.lineno, "shm-owner-teardown",
                            f"{self._label(scope)} creates a shared-"
                            "memory segment but never calls .unlink() "
                            "— the name (and its backing pages) leaks "
                            "past process exit")
            elif use.attaches:
                for call in use.unlinks:
                    yield Finding(
                        mod.path, call.lineno, "shm-attach-unlink",
                        f"{self._label(scope)} only ATTACHES shared-"
                        "memory segments yet calls .unlink() — "
                        "destroying a name it does not own races the "
                        "owner's teardown (attach side must only "
                        ".close() its mapping)")

    @staticmethod
    def _scopes(tree: ast.Module) -> Iterator[ast.AST]:
        """Class bodies, plus module-level functions NOT inside a class
        (a method's shm use belongs to its class's lifecycle)."""
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                yield node
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                yield node

    @staticmethod
    def _label(scope: ast.AST) -> str:
        kind = ("class" if isinstance(scope, ast.ClassDef)
                else "function")
        return f"{kind} {getattr(scope, 'name', '?')!r}"
