"""Rule ``no-host-sync`` — no host synchronization in captured code,
ported from ``repro.analysis.rules.host_sync``.

Scope: code that runs while a CUDA graph is being captured, in the
hot-path modules (``HOT_PATH_MODULES`` in ``repro_torch.analysis.lint``)
and in the files that ``CAPTURED_ENTRY_POINTS`` names:

- the body of every ``with torch.cuda.graph(...)`` block and the
  functions it calls;
- every ``select_mask_traced`` (the fused chunk's selection);
- the file's ``CAPTURED_ENTRY_POINTS`` (``Class.method`` or a function),
  where the capture happens in another file;

each followed through its ``self.`` calls (resolved over the class's
local bases, and to the overrides in its local subclasses, which
``self`` may be) and its calls of functions defined in the same file;
functions nested in captured code are captured too.  Inside, the idioms
that force a device→host sync are bugs:

    float(x)   .item()   .tolist()   .cpu()   .numpy()
    np.asarray(x)   np.array(x)
    torch.nonzero / .nonzero()   torch.unique / .unique()
    torch.masked_select / .masked_select()
    torch.cuda.synchronize() / .synchronize()

Inside a capture a sync either fails the capture or reads a value the
replays never update; on the eager compiled round it stalls the host
once per round.  The host-side halves of the same modules (the round
loop that reads the chunk's masks once, ``CompiledEngine._device_step``,
``FusedEngine.rounds``) use these idioms on purpose and are out of
scope.
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

_GRAPH_NAMES = {"torch.cuda.graph", "torch.cuda.graphs.graph"}
_TRACED_METHODS = {"select_mask_traced"}

_SYNC_CALLS = {"float"}
_SYNC_METHODS_NO_ARGS = {"item", "tolist", "cpu", "numpy"}
_SYNC_METHODS = {"nonzero", "unique", "unique_consecutive", "masked_select", "synchronize"}
_SYNC_DOTTED = {
    "numpy.asarray", "numpy.array", "torch.nonzero", "torch.unique",
    "torch.unique_consecutive", "torch.masked_select", "torch.cuda.synchronize",
}

_Fn = ast.FunctionDef | ast.AsyncFunctionDef


class _Scope:
    """The file's classes, their methods and bases, and its module-level
    functions."""

    def __init__(self, tree: ast.Module):
        self.classes: dict[str, ast.ClassDef] = {}
        self.functions: dict[str, _Fn] = {}
        self.owner: dict[int, ast.ClassDef] = {}  # id(function node) -> its class
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
                for stmt in node.body:
                    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self.owner[id(stmt)] = node

    def method(self, cls: ast.ClassDef, name: str) -> _Fn | None:
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) and stmt.name == name:
                return stmt
        return None

    def mro(self, cls: ast.ClassDef) -> list[ast.ClassDef]:
        out, todo = [], [cls]
        while todo:
            c = todo.pop(0)
            if c in out:
                continue
            out.append(c)
            todo.extend(self.classes[b.id] for b in c.bases
                        if isinstance(b, ast.Name) and b.id in self.classes)
        return out

    def resolve_self(self, cls: ast.ClassDef, name: str) -> list[_Fn]:
        """What ``self.name(...)`` in a method of ``cls`` may run: the first
        definition along its local bases, and every override in a local
        subclass of ``cls``."""
        found = []
        for c in self.mro(cls):
            fn = self.method(c, name)
            if fn is not None:
                found.append(fn)
                break
        for sub in self.classes.values():
            if sub is not cls and cls in self.mro(sub):
                fn = self.method(sub, name)
                if fn is not None:
                    found.append(fn)
        return found

    def entry(self, qualname: str) -> list[_Fn]:
        cls_name, _, fn_name = qualname.rpartition(".")
        if not cls_name:
            fn = self.functions.get(fn_name)
            return [fn] if fn is not None else []
        cls = self.classes.get(cls_name)
        fn = None if cls is None else self.method(cls, fn_name)
        return [fn] if fn is not None else []


def _sync_message(call: ast.Call, aliases: dict[str, str]) -> str | None:
    func = call.func
    name = canonical_call_name(func, aliases)
    if name in _SYNC_DOTTED:
        return (f"{name} in captured code forces a device→host sync; keep the "
                f"value on the device")
    if isinstance(func, ast.Name) and func.id in _SYNC_CALLS:
        return (f"{func.id}() on a value in captured code forces a host sync "
                f"(or bakes a stale value into the graph)")
    if isinstance(func, ast.Attribute) and (
            (func.attr in _SYNC_METHODS_NO_ARGS and not call.args) or func.attr in _SYNC_METHODS):
        return f".{func.attr}() in captured code forces a device→host sync"
    return None


@register_rule
class NoHostSync(Rule):
    name = "no-host-sync"
    description = (
        "no host-sync idioms (float()/.item()/.tolist()/.cpu()/.numpy()/"
        "np.asarray/nonzero/unique/masked_select/synchronize) in code that "
        "runs under a CUDA-graph capture"
    )

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Violation]:
        if not (ctx.is_hot_path or ctx.captured):
            return
        aliases = resolve_aliases(tree)
        scope = _Scope(tree)

        # -- roots: with torch.cuda.graph(...) bodies, select_mask_traced,
        #    the file's cross-file entry points --
        regions: list[tuple[list[ast.stmt], ast.ClassDef | None]] = []
        todo: list[_Fn] = []
        for cls in scope.classes.values():
            for stmt in cls.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and stmt.name in _TRACED_METHODS:
                    todo.append(stmt)
        for qualname in ctx.captured:
            todo.extend(scope.entry(qualname))
        for fn in [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef,
                                                               ast.AsyncFunctionDef))]:
            for node in ast.walk(fn):
                if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                        isinstance(item.context_expr, ast.Call)
                        and canonical_call_name(item.context_expr.func, aliases) in _GRAPH_NAMES
                        for item in node.items):
                    regions.append((node.body, scope.owner.get(id(fn))))

        # -- follow calls: self.<method> over the class chain, bare names to
        #    module-level functions --
        captured: dict[int, _Fn] = {}

        def follow(nodes, cls):
            for sub in nodes:
                for node in ast.walk(sub):
                    if not isinstance(node, ast.Call):
                        continue
                    f = node.func
                    if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                            and f.value.id == "self" and cls is not None):
                        todo.extend(scope.resolve_self(cls, f.attr))
                    elif isinstance(f, ast.Name) and f.id in scope.functions:
                        todo.append(scope.functions[f.id])

        for body, cls in regions:
            follow(body, cls)
        while todo:
            fn = todo.pop()
            if id(fn) in captured:
                continue
            captured[id(fn)] = fn
            follow(fn.body, scope.owner.get(id(fn)))

        # -- flag sync idioms inside captured code --
        seen: set[int] = set()
        bodies = [body for body, _ in regions] + [fn.body for fn in captured.values()]
        for body in bodies:
            for stmt in body:
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call) or id(node) in seen:
                        continue
                    msg = _sync_message(node, aliases)
                    if msg is not None:
                        seen.add(id(node))
                        yield self.violation(ctx, node, msg)
