"""Privacy-plane stream discipline: DP noise and share-mask randomness must
derive from config-threaded streams.

The privacy guarantees (privacy/accountant.py's epsilon report, the
secure_quant masking) are statements about WHERE randomness came from:
noise drawn from an ad-hoc generator minted at the call site is
unauditable (the accountant charges for noise whose stream nothing
pins), and a numpy global-stream draw is order-dependent across threads
— the determinism family's objection, sharpened here because a
perturbed noise stream silently changes the privacy the run actually
delivered.

- ``dp-key-discipline`` — inside ``privacy/`` modules, minting a torch
  stream root (``torch.Generator(...)`` or ``torch.manual_seed(...)``)
  is flagged: generators must be threaded in as arguments by the caller,
  seeded from the config (``engines/base.noise_for`` keys them by seed,
  round, client and leaf). Repo-wide, calling ``add_weak_dp_noise``
  (core/robust.py) with INLINE noise — a ``torch.randn`` /
  ``torch.normal`` draw anywhere in its argument list — is flagged for
  the same reason: the noise comes from ``noise_draws(...)`` of a
  config-keyed generator.

The determinism family already covers numpy global-stream draws
repo-wide (privacy/ included — nidtlint walks the whole package); this
family adds the torch-stream provenance rule the DP paths need on top.
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

#: the torch counterparts of a jax PRNG root
_STREAM_ROOTS = {"torch.Generator", "torch.manual_seed",
                 "torch.random.manual_seed"}
#: inline draws of normal (or uniform) noise
_INLINE_DRAWS = {"torch.randn", "torch.randn_like", "torch.normal",
                 "torch.rand", "torch.rand_like"}


def _call_name(node: ast.AST, aliases: dict[str, str]) -> str | None:
    if not isinstance(node, ast.Call):
        return None
    return normalize(dotted_name(node.func), aliases)


def _inline_draw(arg: ast.AST, aliases: dict[str, str]) -> bool:
    return any(_call_name(n, aliases) in _INLINE_DRAWS
               for n in ast.walk(arg))


@register
class PrivacyKeyDisciplineRule(Rule):
    rule_ids = ("dp-key-discipline",)
    description = ("privacy/ modules must not mint torch stream roots "
                   "(torch.Generator/manual_seed) — noise/mask generators "
                   "are threaded in from config by the caller; repo-wide, "
                   "add_weak_dp_noise must not take inline torch.randn/"
                   "normal noise")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        in_privacy = "privacy" in mod.path_parts
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node, mod.aliases)
            if in_privacy and name in _STREAM_ROOTS:
                yield Finding(
                    mod.path, node.lineno, "dp-key-discipline",
                    f"torch stream root {name}() minted inside privacy/ "
                    "— thread a config-seeded generator in as an "
                    "argument instead (the accountant's epsilon is only "
                    "meaningful for noise whose stream the config pins)")
                continue
            fname = dotted_name(node.func)
            if fname and fname.split(".")[-1] == "add_weak_dp_noise":
                args = list(node.args) + [kw.value for kw in node.keywords
                                          if kw.arg == "noise"]
                if any(_inline_draw(a, mod.aliases) for a in args):
                    yield Finding(
                        mod.path, node.lineno, "dp-key-discipline",
                        "add_weak_dp_noise called with inline "
                        "torch.randn/normal noise — draw it with "
                        "noise_draws(...) from the config-keyed generator "
                        "(per round/client) so the noise stream is "
                        "auditable and replayable")
