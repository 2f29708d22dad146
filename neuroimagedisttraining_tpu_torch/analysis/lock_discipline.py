"""Lock-discipline rules for ``distributed/`` transports.

The broker's concurrency contract (distributed/broker.py:20-26): a frame
must be written atomically under the destination socket's write lock, and
the shared topic/subscriber maps are only touched under the broker lock.
The rule enforces both lexically:

- ``lock-send``       — ``.send``/``.sendall`` on a socket must happen
  inside a ``with <lock>:`` block (any context manager whose dotted name
  mentions "lock"); otherwise two serve threads fanning out to the same
  subscriber can interleave bytes mid-frame and desync the stream.
- ``lock-shared-map`` — mutations of the broker's shared registries
  (``_subs``/``_retained``/``_wlocks``/``_conns`` and friends) must
  happen under a lock; an unlocked ``dict``/``list``/``set`` mutation
  races subscriber registration against teardown.

Lexical means per-function: a helper that writes without taking the lock
is flagged at its ``def`` site even if every current caller holds the
lock — that invariant lives in the callers and must be pragma'd with the
justification where the send happens. The rule fires for files under a
``distributed/``, ``faults/`` or ``asyncfl/`` directory (the
fault-injection wrapper and the selector core both write raw frames —
torn-frame sends carry the same interleaving hazard as the
transports').
"""

from __future__ import annotations

import ast
from typing import Iterator

from neuroimagedisttraining_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Rule,
    dotted_name,
    register,
)

SEND_METHODS = {"send", "sendall", "sendto"}
SHARED_MAP_ATTRS = {"_subs", "_retained", "_wlocks", "_conns",
                    "_subscribers", "_topics"}
MUTATING_METHODS = {"append", "extend", "insert", "remove", "pop",
                    "popitem", "clear", "update", "setdefault", "add",
                    "discard"}


def _is_lock_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.Subscript):  # e.g. self._wlocks[conn]
        return _is_lock_expr(node.value)
    name = dotted_name(node)
    if name is None and isinstance(node, ast.Call):
        # e.g. self._wlocks.setdefault(conn, threading.Lock())
        name = dotted_name(node.func)
    return name is not None and any(
        "lock" in part.lower() for part in name.split("."))


def _shared_attr(node: ast.AST) -> str | None:
    """``self._subs`` (or ``self.x._subs``) -> ``_subs``."""
    if isinstance(node, ast.Attribute) and node.attr in SHARED_MAP_ATTRS:
        return node.attr
    return None


@register
class LockDisciplineRule(Rule):
    rule_ids = ("lock-send", "lock-shared-map")
    description = ("in distributed/ and faults/, socket .send/.sendall "
                   "and mutations of shared topic/subscriber maps must "
                   "sit inside a `with <lock>:` block")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not {"distributed", "faults", "asyncfl"} & set(mod.path_parts):
            return
        yield from self._walk(mod, mod.tree.body, lock_depth=0)

    def _walk(self, mod: ModuleInfo, stmts: list[ast.stmt],
              lock_depth: int) -> Iterator[Finding]:
        for stmt in stmts:
            if isinstance(stmt, ast.With):
                if lock_depth == 0:
                    # the header's own expressions run BEFORE the lock is
                    # held (e.g. `with self._wlocks.setdefault(c, Lock()):`
                    # mutates the shared registry unlocked)
                    yield from self._check_stmt_exprs(mod, stmt)
                held = lock_depth + sum(
                    _is_lock_expr(item.context_expr)
                    for item in stmt.items)
                yield from self._walk(mod, stmt.body, held)
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                # a nested def runs later, outside the enclosing with
                yield from self._walk(mod, stmt.body, lock_depth=0)
                continue
            if lock_depth == 0:
                yield from self._check_stmt_exprs(mod, stmt)
            yield from self._walk_nested_blocks(mod, stmt, lock_depth)

    def _walk_nested_blocks(self, mod: ModuleInfo, stmt: ast.stmt,
                            lock_depth: int) -> Iterator[Finding]:
        """Recurse into if/for/while/try bodies, preserving lock depth."""
        for field in ("body", "orelse", "finalbody"):
            block = getattr(stmt, field, None)
            if isinstance(block, list) and block and isinstance(
                    block[0], ast.stmt):
                yield from self._walk(mod, block, lock_depth)
        for handler in getattr(stmt, "handlers", []) or []:
            yield from self._walk(mod, handler.body, lock_depth)

    def _check_stmt_exprs(self, mod: ModuleInfo,
                          stmt: ast.stmt) -> Iterator[Finding]:
        """Flag unlocked sends / shared-map mutations in this statement's
        own expressions (nested statement blocks are handled by _walk)."""
        for node in self._own_expressions(stmt):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and isinstance(
                        sub.func, ast.Attribute):
                    attr = sub.func.attr
                    recv = sub.func.value
                    if attr in SEND_METHODS and not _shared_attr(recv):
                        yield Finding(
                            mod.path, sub.lineno, "lock-send",
                            f".{attr}() outside a `with <lock>:` block — "
                            "concurrent writers can interleave bytes "
                            "mid-frame (broker.py concurrency contract)")
                    shared = _shared_attr(recv)
                    if shared and attr in MUTATING_METHODS:
                        yield Finding(
                            mod.path, sub.lineno, "lock-shared-map",
                            f"mutation {shared}.{attr}() outside a "
                            "`with <lock>:` block races concurrent "
                            "register/teardown")
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = (stmt.targets if isinstance(stmt, (ast.Assign,
                                                         ast.Delete))
                       else [stmt.target])
            for t in targets:
                if isinstance(t, ast.Subscript):
                    shared = _shared_attr(t.value)
                    if shared:
                        yield Finding(
                            mod.path, t.lineno, "lock-shared-map",
                            f"subscript write to {shared} outside a "
                            "`with <lock>:` block races concurrent "
                            "register/teardown")

    @staticmethod
    def _own_expressions(stmt: ast.stmt) -> Iterator[ast.AST]:
        """The statement's expression children, excluding nested statement
        blocks (those keep their own lock depth via _walk)."""
        for field, value in ast.iter_fields(stmt):
            if isinstance(value, ast.expr):
                yield value
            elif isinstance(value, list):
                for item in value:
                    if isinstance(item, ast.expr):
                        yield item
                    elif isinstance(item, ast.withitem):
                        yield item.context_expr
