"""Round-program-discipline rules: engines declare stages, the builder
owns the window machinery (the reference package's
``analysis/round_program.py``).

The round program (``engines/program.py``) exists so the window runner,
cohort sharding, defenses and codec knobs are written ONCE. In the port
a window is the ``RoundProgram``'s: ``run_window`` runs an engine's
``window_round`` K times, ``stream_window`` fetches a streamed window's
rows (the feed's ``get_window`` / ``prefetch_window``), and the local
steps replay the trainer's ``StepGraph`` captures (``core/trainer.py``).
Two lexical rules keep it that way:

- ``round-program-fused-body`` — no engine module may hand-roll a window
  again: a ``StepGraph(...)`` construction, or a call of the feed's
  ``get_window`` / ``prefetch_window``, lexically inside a
  ``*round*``/``*fused*``/``*window*``-named method of a
  ``FederatedEngine`` subclass (or of the root itself), outside
  ``engines/program.py``, is the copy-the-machinery-back regression this
  rule exists to stop. Engines express K-round windows by declaring
  :class:`RoundStages`; the builder runs them.
- ``round-program-reason`` — fallback reasons come from the single
  source of truth: a ``*_fallback_key`` override must return ``None`` or
  a string literal that is a key of ``engines/program.py``'s ``REASONS``
  table (parsed from source, dependency-free). Ad-hoc reason strings
  resurrect the grep-only fallback reporting that the structured
  ``nidt_fallback_total`` counter replaced.
"""

from __future__ import annotations

import ast
import functools
import os
from typing import Iterator

from neuroimagedisttraining_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Rule,
    dotted_name,
    normalize,
    register,
)
from neuroimagedisttraining_tpu_torch.analysis.engine_contract import (
    _PACKAGED_BASE,
    ROOT_CLASS,
    EngineContractRule,
    _classes_of,
    _parse_file,
    _sibling_classes,
)

_PACKAGED_PROGRAM = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "engines", "program.py")

#: path suffixes allowed to hold window machinery and reason literals —
#: suffix-matched, not basename-matched, so a future pkg/<other>/program.py
#: with a hand-rolled window is NOT exempt
_BUILDER_FILES = ("engines/program.py",)

#: what builds a window: a step graph (by the last part of its dotted
#: name) and the feed's window fetches (by method name)
_GRAPH_CALLS = ("StepGraph",)
_WINDOW_METHODS = ("get_window", "prefetch_window")
_METHOD_MARKS = ("round", "fused", "window")
_KEY_METHODS = ("fused_fallback_key", "cohort_fallback_key")


def _is_builder_file(path: str) -> bool:
    norm = path.replace(os.sep, "/")
    return any(norm == b or norm.endswith("/" + b)
               for b in _BUILDER_FILES)


@functools.lru_cache(maxsize=None)
def _reason_keys(path: str = _PACKAGED_PROGRAM) -> frozenset[str]:
    """The REASONS table's keys, parsed from engines/program.py source
    (the linter stays dependency-free — no torch import; the result is
    constant per process, so one parse serves every linted module)."""
    try:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
    except (OSError, SyntaxError):
        return frozenset()
    for node in ast.walk(tree):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if any(isinstance(t, ast.Name) and t.id == "REASONS"
               for t in targets) and isinstance(node.value, ast.Dict):
            return frozenset(
                k.value for k in node.value.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str))
    return frozenset()


def _window_calls_in(fn: ast.AST, aliases: dict) -> Iterator[ast.Call]:
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = normalize(dotted_name(node.func), aliases) or ""
        if name.split(".")[-1] in _GRAPH_CALLS or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _WINDOW_METHODS):
            yield node


@register
class RoundProgramRule(Rule):
    rule_ids = ("round-program-fused-body", "round-program-reason")
    description = ("engines declare round stages through the builder "
                   "(engines/program.py): no hand-rolled windows (a "
                   "StepGraph or the feed's get_window/prefetch_window in "
                   "a *round*/*fused*/*window* method of an engine class), "
                   "and *_fallback_key overrides return keys from the "
                   "REASONS table")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if _is_builder_file(mod.path):
            return
        classes = _classes_of(mod.tree)
        table = _sibling_classes(mod.path)
        table.update(classes)
        if ROOT_CLASS not in table:
            table.update(_parse_file(_PACKAGED_BASE))
        engine_classes = {
            name for name, info in classes.items()
            if name == ROOT_CLASS
            or EngineContractRule._engine_ancestry(info, table) is not None}
        if not engine_classes:
            return
        keys = _reason_keys()
        for node in mod.tree.body:
            if not isinstance(node, ast.ClassDef) \
                    or node.name not in engine_classes:
                continue
            for stmt in node.body:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    yield from self._check_method(mod, node, stmt, keys)

    def _check_method(self, mod: ModuleInfo, cls: ast.ClassDef,
                      fn: ast.FunctionDef, keys: frozenset[str]
                      ) -> Iterator[Finding]:
        name = fn.name.lower()
        if any(m in name for m in _METHOD_MARKS):
            for call in _window_calls_in(fn, mod.aliases):
                yield Finding(
                    mod.path, call.lineno, "round-program-fused-body",
                    f"{cls.name}.{fn.name} hand-rolls a window (a step "
                    "graph or a window fetch); engines declare RoundStages "
                    "and the builder (engines/program.py RoundProgram) "
                    "owns the window — hand-rolled copies drift from the "
                    "capture/sharding/window contracts")
        if fn.name in _KEY_METHODS and keys:
            for node in ast.walk(fn):
                if isinstance(node, ast.Return) \
                        and isinstance(node.value, ast.Constant) \
                        and isinstance(node.value.value, str) \
                        and node.value.value not in keys:
                    yield Finding(
                        mod.path, node.lineno, "round-program-reason",
                        f"{cls.name}.{fn.name} returns "
                        f"{node.value.value!r}, which is not a key of "
                        "engines/program.py REASONS — fallback reasons "
                        "have ONE source of truth (the structured "
                        "nidt_fallback_total counter labels by key)")


__all__ = ["RoundProgramRule"]
