"""Async-discipline rules: no blocking calls inside ``asyncfl/`` coroutines.

The load harness (asyncfl/loadgen.py) runs THOUSANDS of simulated
clients as coroutines on one event loop. A single blocking call inside
any ``async def`` body freezes every one of them at once — and unlike a
crash, it freezes them silently: the benchmark still "works", just with
the concurrency quietly serialized. The classic offenders all have
non-blocking spellings one import away (``asyncio.sleep``,
``loop.sock_recv``, awaited stream reads), so the rule family bans the
blocking forms lexically:

- ``async-blocking-call`` — inside an ``async def`` in ``asyncfl/``, a
  NON-awaited call to ``time.sleep``, ``select.select``, or a socket-
  style blocking method (``.accept()``/``.recv()``/``.recv_into()``/
  ``.recvfrom()``/``.sendall()``/``.connect()``) is flagged. Awaited
  calls are exempt by construction (``await loop.sock_connect(...)`` is
  the sanctioned spelling), and so are nested SYNC ``def``/``lambda``
  bodies — those are exactly what ``run_in_executor`` ships off-loop.
- ``async-queue-get`` — a ``.get()`` call with no positional arguments
  and neither ``timeout=`` nor ``block=False`` inside an ``async def``
  is a blocking ``queue.Queue.get`` (a ``dict.get`` always has a key
  argument, so it never matches); use ``asyncio.Queue`` and await it,
  or pass a timeout.

Scoped to ``asyncfl/`` like the lock rules are scoped to
``distributed/``+``faults/``: the rest of the tree has no event loop to
starve, and e.g. the engines legitimately sleep in fault-injection
paths.
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

#: dotted calls that block the thread (normalized through import aliases)
BLOCKING_DOTTED = {"time.sleep", "select.select"}
#: attribute spellings of blocking socket I/O; receivers travel under
#: too many names to resolve, so the method name is the signal
BLOCKING_SOCKET_METHODS = {"accept", "recv", "recv_into", "recvfrom",
                           "sendall", "connect"}


def _is_awaited(node: ast.Call, parents: dict[ast.AST, ast.AST]) -> bool:
    return isinstance(parents.get(node), ast.Await)


def _parent_map(root: ast.AST) -> dict[ast.AST, ast.AST]:
    return {child: parent for parent in ast.walk(root)
            for child in ast.iter_child_nodes(parent)}


def _async_body_calls(fn: ast.AsyncFunctionDef) -> Iterator[ast.Call]:
    """Calls lexically inside ``fn``'s own body: nested SYNC functions
    and lambdas are excluded (executor-shipped bodies are allowed to
    block), and nested ``async def`` are excluded HERE because
    ``check`` visits every AsyncFunctionDef itself — descending into
    them too would report each violation twice."""
    stack: list[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


@register
class AsyncDisciplineRule(Rule):
    rule_ids = ("async-blocking-call", "async-queue-get")
    description = (
        "inside async def bodies in asyncfl/, no non-awaited blocking "
        "calls: time.sleep / select.select / socket .accept/.recv/"
        ".sendall/.connect (async-blocking-call) and no bare queue "
        ".get() without timeout (async-queue-get)")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if "asyncfl" not in mod.path_parts:
            return
        parents = _parent_map(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            for call in _async_body_calls(node):
                if _is_awaited(call, parents):
                    continue
                yield from self._check_call(mod, node, call)

    def _check_call(self, mod: ModuleInfo, fn: ast.AsyncFunctionDef,
                    call: ast.Call) -> Iterator[Finding]:
        name = normalize(dotted_name(call.func), mod.aliases)
        if name in BLOCKING_DOTTED:
            yield Finding(
                mod.path, call.lineno, "async-blocking-call",
                f"blocking {name}() inside async def {fn.name!r} freezes "
                "every coroutine on the loop — await asyncio.sleep / use "
                "the loop's non-blocking I/O instead")
            return
        if not isinstance(call.func, ast.Attribute):
            return
        attr = call.func.attr
        if attr in BLOCKING_SOCKET_METHODS:
            yield Finding(
                mod.path, call.lineno, "async-blocking-call",
                f"blocking socket .{attr}() inside async def "
                f"{fn.name!r} — await the asyncio stream/loop.sock_* "
                "equivalent (non-awaited blocking I/O serializes the "
                "whole client fleet)")
        elif attr == "get" and not call.args and not any(
                kw.arg in ("timeout", "block") for kw in call.keywords):
            yield Finding(
                mod.path, call.lineno, "async-queue-get",
                f"bare .get() inside async def {fn.name!r} is a "
                "blocking queue read (dict.get always takes a key) — "
                "use asyncio.Queue and await it, or pass timeout=")
