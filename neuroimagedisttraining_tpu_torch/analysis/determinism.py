"""Determinism rules: no global-state or unseeded numpy randomness.

Bit-faithful reproduction of the JAX package hangs on every random draw
being derived from an explicit seed: client sampling re-seeds numpy's
LEGACY global stream per round only because the original code does
(engines/base.py ``client_sampling``, fedavg_api.py:92-100), and the
additive-share masks of ``ops/mpc.py`` draw from it as the JAX package's
module does — those shims are pragma-annotated, not silently allowed, so
the next one added is a conscious decision.

- ``determinism-global-random`` — any call through numpy's global RNG
  (``np.random.seed``/``choice``/``rand``/...): global-stream draws are
  order-dependent across threads and modules, so results stop being a
  pure function of the config seed.
- ``determinism-unseeded-rng`` — ``np.random.default_rng()`` /
  ``RandomState()`` with no seed pulls OS entropy; every generator must
  be constructed from a config-derived seed.

Seeded constructors (``default_rng(seed)``, ``RandomState(seed)``) and
``torch.Generator`` streams seeded from the config are the sanctioned
APIs and are never flagged; torch's own generators are the privacy
family's concern (``analysis/privacy_discipline.py``).
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

#: constructors of independent generators — fine when given a seed
_CONSTRUCTORS = {"default_rng", "RandomState", "Generator", "SeedSequence",
                 "PCG64", "Philox", "MT19937", "SFC64", "BitGenerator"}


def _np_random_member(call: ast.Call, aliases: dict[str, str]) -> str | None:
    name = normalize(dotted_name(call.func), aliases)
    if name and name.startswith("numpy.random."):
        return name[len("numpy.random."):]
    return None


@register
class DeterminismRule(Rule):
    rule_ids = ("determinism-global-random", "determinism-unseeded-rng")
    description = ("no numpy global-stream randomness (np.random.seed/"
                   "choice/...) and no unseeded default_rng()/RandomState()"
                   " — every draw must derive from a config seed")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            member = _np_random_member(node, mod.aliases)
            if member is None or "." in member:
                continue
            if member in _CONSTRUCTORS:
                if not node.args and not node.keywords:
                    yield Finding(
                        mod.path, node.lineno, "determinism-unseeded-rng",
                        f"np.random.{member}() without a seed draws OS "
                        "entropy — derive the seed from the experiment "
                        "config instead")
            else:
                yield Finding(
                    mod.path, node.lineno, "determinism-global-random",
                    f"np.random.{member} uses numpy's GLOBAL stream — "
                    "order-dependent across modules/threads; use a seeded "
                    "np.random.default_rng(...) (reference-parity shims "
                    "must carry a pragma citing the reference lines)")
