"""``analysis/``: the port's static checker and the tools that read a
finished run (the reference package's ``analysis/``).

``nidtlint`` turns the port's declarative contracts from comments into
machine-checked rules, run as a tier-1 gate
(``tests/test_torch_contracts.py``). Its whole-program pass
(``--project``) checks the cross-file contracts — flag<->config
lockstep, metric-name, fallback-reason, recipe-key and reflex-action
closure, and the compatibility matrix as data (``analysis/project.py``
+ ``analysis/contracts.py``). The per-file pass runs the ``pragma`` rule
and twelve families with the reference's ids: ``async_discipline`` (no
blocking call in an ``asyncfl/`` coroutine), ``lock_discipline`` (sends
and shared maps under a lock in ``distributed/``, ``faults/`` and
``asyncfl/``), ``shm_discipline`` (shared-memory owners and attachers),
``determinism`` (numpy's global stream and unseeded generators),
``privacy_discipline`` (torch stream roots in ``privacy/``, inline weak-DP
noise), ``health_discipline`` (metric-name literals outside ``obs/``),
``engine_contract`` (engine classes' names, round method and base
signatures), ``round_program`` (no hand-rolled window outside
``engines/program.py``, fallback reasons from its table),
``trace_safety`` (no host sync or numpy draw inside a captured step:
a ``StepGraph`` body, a ``torch.cuda.graph`` block and their resolvable
callees), ``obs_discipline`` (no clock, metric or sync inside a captured
step; the trace-context key and batched ingest pipe),
``mesh_discipline`` (pad-row weights from ``parallel/cohort.py``; the
reference's ``shard_map`` spec rule is JAX-only) and
``precision_discipline`` (no float32 upcast inside a captured step under
``core/``, ``ops/`` and ``models/``).

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
    engine_contract,
    health_discipline,
    lock_discipline,
    mesh_discipline,
    obs_discipline,
    precision_discipline,
    privacy_discipline,
    round_program,
    shm_discipline,
    trace_safety,
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
