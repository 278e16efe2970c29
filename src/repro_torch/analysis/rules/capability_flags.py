"""Rule ``capability-flags`` — strategy capability flags match methods,
ported from ``repro.analysis.rules.capability_flags``.

The mask-gated backends dispatch on two class-level capability flags
(``repro_torch/core/strategies.py``, the pairs of
``repro_torch.engine.registry``): ``supports_compiled_selection``
promises ``select_mask`` and ``supports_traced_selection`` promises
``select_mask_traced``.  A flag without its method crashes the first
compiled/fused round that uses the strategy; a method without its flag
is silently never used.  Both directions are checked.

Resolution is over the *local* class chain — bases defined in the same
file are followed (so ``ClusterRandom(FedLECC)`` sees FedLECC's methods
and ``FedLECCAdaptive``'s explicit ``supports_traced_selection = False``
opt-out is honoured against the inherited method).  When any base is
imported from elsewhere, the "method missing" direction is skipped —
the runtime guard in ``repro_torch.engine.registry.register_strategy``
performs the same check over the real MRO at import time.
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.lint import FileContext, Violation
from repro_torch.analysis.rules import Rule, register_rule

_PAIRS = (
    ("supports_compiled_selection", "select_mask"),
    ("supports_traced_selection", "select_mask_traced"),
)


def _own_flag(cls: ast.ClassDef, flag: str) -> bool | None:
    """The flag's literal bool value assigned in this class body, or None."""
    for stmt in cls.body:
        targets: list[ast.expr] = []
        value: ast.expr | None = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        for t in targets:
            if isinstance(t, ast.Name) and t.id == flag:
                if isinstance(value, ast.Constant) and isinstance(value.value, bool):
                    return value.value
    return None


def _own_method(cls: ast.ClassDef, method: str) -> bool:
    return any(
        isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
        and stmt.name == method
        for stmt in cls.body
    )


@register_rule
class CapabilityFlags(Rule):
    name = "capability-flags"
    description = (
        "supports_compiled_selection/supports_traced_selection must match "
        "select_mask/select_mask_traced definitions, both directions"
    )

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Violation]:
        local: dict[str, ast.ClassDef] = {
            n.name: n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
        }

        def chain(cls: ast.ClassDef) -> tuple[list[ast.ClassDef], bool]:
            """(MRO-ordered local chain, every-base-resolved?)."""
            out, complete, todo = [], True, [cls]
            while todo:
                c = todo.pop(0)
                if c in out:
                    continue
                out.append(c)
                for base in c.bases:
                    if isinstance(base, ast.Name) and base.id == "object":
                        continue
                    if isinstance(base, ast.Name) and base.id in local:
                        todo.append(local[base.id])
                    else:
                        complete = False
            return out, complete

        for cls in local.values():
            mro, complete = chain(cls)
            for flag, method in _PAIRS:
                effective = next(
                    (v for c in mro if (v := _own_flag(c, flag)) is not None),
                    None,
                )
                in_chain = any(_own_method(c, method) for c in mro)
                if effective is True and not in_chain and complete:
                    yield self.violation(
                        ctx, cls,
                        f"class {cls.name!r} advertises {flag} = True but "
                        f"neither it nor its (local) bases define {method}()",
                    )
                if _own_method(cls, method) and _own_flag(cls, flag) is False:
                    yield self.violation(
                        ctx, cls,
                        f"class {cls.name!r} defines {method}() but sets "
                        f"{flag} = False in the same body — the backends "
                        f"will never call it",
                    )
                if (
                    _own_method(cls, method)
                    and effective is not True
                    and complete
                    and _own_flag(cls, flag) is not False
                ):
                    yield self.violation(
                        ctx, cls,
                        f"class {cls.name!r} defines {method}() but never "
                        f"sets {flag} = True — the mask-gated backends will "
                        f"silently skip it",
                    )
