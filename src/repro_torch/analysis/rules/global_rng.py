"""Rule ``no-global-rng`` — no global-state RNG in library code, ported
from ``repro.analysis.rules.global_rng``.

Every random draw in the port is reproducible because it comes from an
explicitly seeded stream: a ``np.random.default_rng(seed)`` generator, a
``torch.Generator`` passed as ``generator=``, or the engine's counter
hashes (``repro_torch.engine.draws``).  Calls that mutate or read the
*module level* numpy/stdlib RNG state (``np.random.normal``,
``np.random.seed``, ``random.random``, ...) or torch's default
generators (``torch.manual_seed``, ``torch.cuda.manual_seed_all``, a
``torch.rand`` / ``randperm`` / ``normal`` / ... or an in-place
``uniform_`` / ``normal_`` / ... without ``generator=``) silently couple
components through hidden global state and break the per-(seed, round)
determinism that host ≡ compiled ≡ fused rests on.
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.lint import FileContext, Violation
from repro_torch.analysis.rules import (
    Rule,
    canonical_call_name,
    register_rule,
    resolve_aliases,
)

# Constructors of *seeded, local* state are fine; everything else on
# numpy.random is a module-level draw or a global-state mutation.
_NUMPY_ALLOWED = {
    "default_rng", "Generator", "RandomState", "SeedSequence",
    "PCG64", "PCG64DXSM", "Philox", "MT19937", "SFC64", "BitGenerator",
}
# Calls that seed (or reseed) torch's default generators.
_TORCH_SEEDING = {
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed", "torch.random.seed",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all", "torch.cuda.seed",
    "torch.cuda.seed_all",
}
# torch samplers: without ``generator=`` they draw from the default generator.
_TORCH_SAMPLERS = {
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like", "randperm",
    "bernoulli", "multinomial", "normal", "poisson",
}
# In-place samplers (tensor methods and ``torch.nn.init``'s), same rule.
_INPLACE_SAMPLERS = {
    "uniform_", "normal_", "exponential_", "random_", "bernoulli_", "geometric_",
    "cauchy_", "log_normal_",
}


def _has_generator(node: ast.Call) -> bool:
    return any(k.arg == "generator" for k in node.keywords)


@register_rule
class NoGlobalRNG(Rule):
    name = "no-global-rng"
    description = (
        "no module-level RNG (np.random.* draws, random.*, torch.manual_seed, "
        "torch samplers without generator=) in library code — use a seeded "
        "np.random.default_rng, a torch.Generator or the engine's draws"
    )

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Violation]:
        aliases = resolve_aliases(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = canonical_call_name(node.func, aliases)
            if name is not None and name.startswith("numpy.random."):
                tail = name.split(".", 2)[2]
                if tail.split(".")[0] not in _NUMPY_ALLOWED:
                    yield self.violation(
                        ctx, node,
                        f"module-level numpy RNG call {name!r} draws from "
                        f"hidden global state; use a seeded "
                        f"np.random.default_rng(seed) generator",
                    )
            elif (name is not None and name.startswith("random.")
                  and aliases.get("random", "") == "random"):
                yield self.violation(
                    ctx, node,
                    f"stdlib global RNG call {name!r}; use a seeded "
                    f"np.random.default_rng(seed) or a torch.Generator",
                )
            elif name in _TORCH_SEEDING:
                yield self.violation(
                    ctx, node,
                    f"{name!r} reseeds torch's global generator, which every "
                    f"draw without generator= shares; seed a torch.Generator",
                )
            elif (name is not None and name.startswith("torch.")
                  and name[len("torch."):] in _TORCH_SAMPLERS and not _has_generator(node)):
                yield self.violation(
                    ctx, node,
                    f"{name!r} without generator= draws from torch's global "
                    f"generator; pass a seeded torch.Generator",
                )
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _INPLACE_SAMPLERS and not _has_generator(node)):
                yield self.violation(
                    ctx, node,
                    f".{node.func.attr}() without generator= draws from "
                    f"torch's global generator; pass a seeded torch.Generator",
                )
