"""health-rule-discipline: metric names live in the declared table.

The anomaly-rule engine (obs/rules.py) validates every rule manifest —
built-in and ``--health_rules``-loaded — against the declared
metric-name set in ``obs/names.py`` at STARTUP, so a typo'd rule fails
with the known-names list instead of silently never firing. That
contract only holds while the declared set actually covers every name
the tree publishes, which is what this lint family enforces from the
other side:

- ``health-metric-literal``: a string literal that IS a metric name
  (full-match ``nidt_[a-z0-9_]+``) anywhere outside the ``obs/``
  package is a finding — spell the ``obs/names.py`` constant instead.
  A literal spelling registers and publishes fine today and silently
  drifts out of the declared set the day it is renamed, at which point
  every rule watching it goes permanently dark (the exact failure mode
  the trace-ctx-key rule fences for the flow chain). Prose that merely
  MENTIONS a metric ("the nidt_mfu gauge's denominator") is not a full
  match and is untouched; derived exposition names are spelled as
  ``obs_names.X + "_bucket"``.

``obs/`` itself is exempt: it is the declaration side — ``names.py``
holds the constants, and the obs modules' registrations are the
definitions the table mirrors.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from neuroimagedisttraining_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Rule,
    register,
)

#: a whole-string metric name (not prose containing one)
METRIC_NAME_RE = re.compile(r"nidt_[a-z0-9_]+\Z")


def _in_obs_package(mod: ModuleInfo) -> bool:
    return "obs" in mod.path_parts[:-1]


@register
class HealthRuleDisciplineRule(Rule):
    rule_ids = ("health-metric-literal",)
    description = (
        "metric-name string literals (full-match nidt_*) outside the "
        "obs/ package — spell the obs/names.py constant so the "
        "declared-name set the anomaly-rule engine validates against "
        "(obs/rules.py) stays the single source of truth")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if _in_obs_package(mod):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Constant) \
                    or not isinstance(node.value, str):
                continue
            if METRIC_NAME_RE.fullmatch(node.value):
                yield Finding(
                    mod.path, node.lineno, "health-metric-literal",
                    f"metric name {node.value!r} spelled as a string "
                    "literal outside obs/ — use the obs/names.py "
                    "constant (a renamed literal silently leaves the "
                    "declared set the health rules are validated "
                    "against)")


__all__ = ["HealthRuleDisciplineRule", "METRIC_NAME_RE"]
