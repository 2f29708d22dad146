"""``analysis/``: the port's static checker and the tools that read a
finished run (the reference package's ``analysis/``).

``nidtlint`` turns the port's declarative contracts from comments into
machine-checked rules, run as a tier-1 gate
(``tests/test_torch_contracts.py``). Its whole-program pass
(``--project``) checks the cross-file contracts — flag<->config
lockstep, metric-name, fallback-reason, recipe-key and reflex-action
closure, and the compatibility matrix as data (``analysis/project.py``
+ ``analysis/contracts.py``). The per-file pass runs the ``pragma`` rule;
the port's per-file families are still to come.

CLI::

    python -m neuroimagedisttraining_tpu_torch.analysis <paths> [--json]
    python -m neuroimagedisttraining_tpu_torch.analysis --project [--json]
    python -m neuroimagedisttraining_tpu_torch.analysis --regen-compat
    python -m neuroimagedisttraining_tpu_torch.analysis --list-rules

Suppression: ``# nidt: allow[rule-id] -- one-line justification`` on the
offending line; the justification is mandatory (rule ``pragma``).

- :mod:`analysis.run_report`: the metrics JSONL sink, the flight dump and
  the health verdict joined into one report.
"""

from neuroimagedisttraining_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    RULE_REGISTRY,
    Rule,
    all_rule_ids,
    lint_paths,
    lint_source,
    register,
)

# importing the rule module registers every project family
from neuroimagedisttraining_tpu_torch.analysis import (  # noqa: E402,F401
    contracts,
)

from neuroimagedisttraining_tpu_torch.analysis.project import (  # noqa: E402,F401
    lint_project,
)

__all__ = [
    "Finding",
    "Rule",
    "RULE_REGISTRY",
    "all_rule_ids",
    "lint_paths",
    "lint_project",
    "lint_source",
    "register",
]
