"""precision-discipline rules: no stray float32 upcasts in the local step
(the reference package's ``analysis/precision_discipline.py``).

The mixed-precision contract (``core/optim.py``) is arithmetic, not
style: under ``precision=bf16_mixed`` the step's compute and activations
are bfloat16 while the master weights, momentum and loss stay float32. A
bare ``.float()`` or ``.to(torch.float32)`` inside a captured step
silently widens an activation mid-step: the bf16 model pays f32 memory
traffic for that tensor on every replay, and nothing fails.

The rule rides the trace-safety resolver (``collect_traced``: the
``StepGraph`` bodies, the ``torch.cuda.graph`` blocks and their
resolvable callees) and fires for files under the step's planes —
``core/``, ``ops/``, ``models/`` — on ``.float()``,
``.to(torch.float32)`` / ``.to(dtype=torch.float32)`` (the dtype as any
positional argument) and ``torch.tensor`` / ``torch.as_tensor`` /
``torch.asarray(..., dtype=torch.float32)``. The engines' aggregation
tails are out of scope: they work on the float32 master weights by
contract.

Blessed sites inside the scope (the input's raw cast, the loss's float32
value) carry ``# nidt: allow[precision-upcast] -- reason`` pragmas, the
escape hatch the contract names. The flax-style BatchNorm's float32
statistics (``models/neuro3d.py``) run in the model's forward, which a
step reaches through ``torch.func.functional_call`` — not a lexically
resolvable call — so the rule does not reach them.
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
from neuroimagedisttraining_tpu_torch.analysis.trace_safety import (
    calls_in_captured,
)

#: canonical dotted names that denote the float32 dtype
F32_DOTTED = {"torch.float32", "torch.float"}

#: tensor constructors whose ``dtype=`` the rule reads
CAST_DOTTED = {"torch.tensor", "torch.as_tensor", "torch.asarray"}


def _is_f32(node: ast.AST | None, aliases: dict[str, str]) -> bool:
    return node is not None and normalize(dotted_name(node),
                                          aliases) in F32_DOTTED


@register
class PrecisionDisciplineRule(Rule):
    rule_ids = ("precision-upcast",)
    description = (
        "no bare float32 upcasts (.float(), .to(torch.float32), "
        "torch.tensor(..., dtype=torch.float32)) inside captured steps "
        "under core/, ops/, models/ — the bf16_mixed contract keeps "
        "compute in the model dtype; blessed master-weight/loss sites "
        "carry a precision-upcast pragma")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not {"core", "ops", "models"} & set(mod.path_parts):
            return
        for node in calls_in_captured(mod):
            yield from self._check_call(mod, node)

    def _check_call(self, mod: ModuleInfo,
                    node: ast.Call) -> Iterator[Finding]:
        aliases = mod.aliases
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr == "float" \
                and not node.args:
            yield Finding(
                mod.path, node.lineno, "precision-upcast",
                ".float() inside a captured step widens a tensor "
                "regardless of the precision policy — use the model's "
                "compute dtype, or pragma a blessed master-weight/loss "
                "site")
            return
        if isinstance(func, ast.Attribute) and func.attr == "to" and (
                any(_is_f32(a, aliases) for a in node.args)
                or any(k.arg == "dtype" and _is_f32(k.value, aliases)
                       for k in node.keywords)):
            yield Finding(
                mod.path, node.lineno, "precision-upcast",
                ".to(torch.float32) inside a captured step widens a "
                "tensor regardless of the precision policy — use the "
                "model's compute dtype, or pragma a blessed site")
            return
        name = normalize(dotted_name(func), aliases)
        if name in CAST_DOTTED and any(
                k.arg == "dtype" and _is_f32(k.value, aliases)
                for k in node.keywords):
            yield Finding(
                mod.path, node.lineno, "precision-upcast",
                f"{name}(..., dtype=torch.float32) inside a captured step "
                "is an unconditional float32 tensor — thread the compute "
                "dtype, or pragma a blessed site")


__all__ = ["PrecisionDisciplineRule", "F32_DOTTED", "CAST_DOTTED"]
