"""Mesh-discipline rules: one pad-weight rule (the reference package's
``analysis/mesh_discipline.py``).

Cohort sharding (``parallel/cohort.py``) made zero-weight pad rows a
correctness invariant: a pad row that keeps its gathered sample count
VOTES in the aggregation — silently, since a pad often repeats a real
client's id. So:

- ``mesh-pad-weights`` — pad-row weight masks come from THE shared
  helper (``parallel.cohort.pad_row_weights``); rebuilding the
  ``arange(...) < n_real`` position mask by hand is flagged anywhere
  outside ``parallel/cohort.py``. The helper is one line — the rule
  exists because the half-correct rewrite (zeroing by gathered sample
  count instead of by position) type-checks, runs, and double-counts a
  repeated client.

The reference's other rule, ``mesh-shardmap-specs`` (every
``shard_map`` call passes explicit ``in_specs`` and ``out_specs``), is
not registered: it checks JAX's ``shard_map`` placement contract, and the
port has no ``shard_map``. Its mesh places a client block on an entry by
an explicit copy (``parallel/mesh.py``, ``parallel/cohort.py``), which
leaves no spec to omit.
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

#: the one module allowed to build pad-row position masks by hand
_PAD_HELPER_HOME = "cohort.py"


def _is_arange_call(node: ast.AST, aliases: dict) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = normalize(dotted_name(node.func), aliases) or ""
    return name.split(".")[-1] == "arange"


def _terminal_name(node: ast.AST) -> str | None:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


@register
class MeshDisciplineRule(Rule):
    rule_ids = ("mesh-pad-weights",)
    description = (
        "pad-row zero-weight masks must come from "
        "parallel.cohort.pad_row_weights, not ad-hoc arange(...) < n_real "
        "comparisons (mesh-pad-weights)")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if mod.path_parts and mod.path_parts[-1] == _PAD_HELPER_HOME \
                and "parallel" in mod.path_parts:
            return  # the helper's own home
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Compare):
                continue
            sides = [node.left] + list(node.comparators)
            has_arange = any(_is_arange_call(s, mod.aliases)
                             for s in sides)
            names = {_terminal_name(s) for s in sides}
            if has_arange and "n_real" in names:
                yield Finding(
                    mod.path, node.lineno, "mesh-pad-weights",
                    "ad-hoc pad-row mask (arange(...) compared against "
                    "n_real) — use parallel.cohort.pad_row_weights, the "
                    "one audited zero-weight construction (pads may "
                    "DUPLICATE a real client id; zeroing by position is "
                    "the only correct rule)")


__all__ = ["MeshDisciplineRule"]
