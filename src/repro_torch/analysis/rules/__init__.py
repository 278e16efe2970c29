"""The tracecheck rule registry and shared AST helpers, ported from
``repro.analysis.rules``.

Each rule module defines a ``Rule`` subclass and registers an instance
with ``@register_rule``; ``RULES`` maps rule name → instance.  Rules are
pure functions of ``(ast.Module, FileContext)`` returning ``Violation``
lists — no imports of the code under analysis, no torch.
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.lint import FileContext, Violation

__all__ = [
    "RULES",
    "Rule",
    "canonical_call_name",
    "dotted_name",
    "register_rule",
    "resolve_aliases",
    "rule_catalog",
]

RULES: dict[str, "Rule"] = {}


class Rule:
    """Base class: ``name`` identifies the rule (and its pragma key),
    ``description`` feeds the catalog (``--list``)."""

    name: str = ""
    description: str = ""

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Violation]:
        raise NotImplementedError

    def violation(self, ctx: FileContext, node: ast.AST, message: str) -> Violation:
        return Violation(
            rule=self.name, path=ctx.path,
            line=getattr(node, "lineno", 0), col=getattr(node, "col_offset", 0),
            message=message,
        )


def register_rule(cls: type[Rule]) -> type[Rule]:
    inst = cls()
    if not inst.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    if inst.name in RULES:
        raise ValueError(f"duplicate rule {inst.name!r}")
    RULES[inst.name] = inst
    return cls


def rule_catalog() -> list[tuple[str, str]]:
    """Sorted (name, description) pairs for ``--list`` and the docs."""
    return sorted((r.name, r.description) for r in RULES.values())


# ---------------------------------------------------------------- helpers
def dotted_name(node: ast.AST) -> str | None:
    """``torch.cuda.graph`` → ``"torch.cuda.graph"`` (None for anything
    that is not a plain Name/Attribute chain)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve_aliases(tree: ast.Module) -> dict[str, str]:
    """Import-alias map: local name → canonical dotted module path.

    ``import numpy.random as npr`` → ``{"npr": "numpy.random"}``;
    ``from torch import cuda`` → ``{"cuda": "torch.cuda"}``;
    ``import numpy as np`` → ``{"np": "numpy"}``.
    """
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def canonical_call_name(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Resolve a call target through import aliases to its canonical
    dotted path (``npr.normal`` → ``numpy.random.normal``)."""
    dotted = dotted_name(node)
    if dotted is None:
        return None
    head, _, rest = dotted.partition(".")
    root = aliases.get(head, head)
    return f"{root}.{rest}" if rest else root


# Rule modules register themselves on import (kept at the bottom so the
# helpers above exist when they do).
from repro_torch.analysis.rules import (  # noqa: E402,F401
    capability_flags,
    capture_stream,
    global_rng,
    host_sync,
)
