"""``analysis/``: the port's static checker and the tools that read a
finished run (the reference package's ``analysis/``).

``nidtlint`` turns the port's declarative contracts from comments into
machine-checked rules, run as a tier-1 gate
(``tests/test_torch_contracts.py``). Its whole-program pass
(``--project``) checks the cross-file contracts — flag<->config
lockstep, metric-name, fallback-reason, recipe-key and reflex-action
closure, and the compatibility matrix as data (``analysis/project.py``
+ ``analysis/contracts.py``). The per-file pass runs the ``pragma`` rule
and six families with the reference's ids: ``async_discipline`` (no
blocking call in an ``asyncfl/`` coroutine), ``lock_discipline`` (sends
and shared maps under a lock in ``distributed/``, ``faults/`` and
``asyncfl/``), ``shm_discipline`` (shared-memory owners and attachers),
``determinism`` (numpy's global stream and unseeded generators),
``privacy_discipline`` (torch stream roots in ``privacy/``, inline weak-DP
noise) and ``health_discipline`` (metric-name literals outside ``obs/``).
The families that check captured step graphs, the engine contract and
the round program are still to come.

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

# importing the rule modules registers every rule family
from neuroimagedisttraining_tpu_torch.analysis import (  # noqa: E402,F401
    async_discipline,
    contracts,
    determinism,
    health_discipline,
    lock_discipline,
    privacy_discipline,
    shm_discipline,
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
