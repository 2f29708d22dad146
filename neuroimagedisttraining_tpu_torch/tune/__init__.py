"""Closed-loop autotuner (the reference package's ``tune/``): search the
declared probe space, emit per-hardware recipes, re-tune on MFU drift.

- :mod:`tune.space` — the search space as DATA: the probe cell axes
  (obs/probe.py CELL_KEYS, ``batch`` included) with per-axis validity
  predicates reusing the compat-matrix rejection knowledge
  (``analysis/compat_matrix.py``) and device-kind-aware memory bounds.
  Never proposes a cell the CLI would reject at startup.
- :mod:`tune.search` — seeded successive halving: cheap short-window
  screens, survivors re-measured at the committed window; every
  measurement keyed by cell fingerprint in a JSONL journal so a killed
  run resumes without re-measuring.
- :mod:`tune.recipe` — the winner serialized as
  ``neuroimagedisttraining_tpu_torch/recipes/<device_kind>.json``
  (sha256-pinned, full score trace retained), loadable via ``--recipe
  <path|auto>`` on the CLI; loading arms the ``mfu-below-recipe`` drift
  rule.

Entry points::

    python -m neuroimagedisttraining_tpu_torch.tune --backend virtual \
        --device cpu --virtual_devices 2
    python -m neuroimagedisttraining_tpu_torch.tune --backend driver
    python -m neuroimagedisttraining_tpu_torch ... --recipe auto
"""

from neuroimagedisttraining_tpu_torch.tune.space import (  # noqa: F401
    Space, build_space, cell_fingerprint,
)
from neuroimagedisttraining_tpu_torch.tune.search import (  # noqa: F401
    Journal, run_search, virtual_measure,
)
from neuroimagedisttraining_tpu_torch.tune.recipe import (  # noqa: F401
    RECIPE_KEYS, apply_recipe, drift_rules, load_recipe,
    resolve_and_load,
)
