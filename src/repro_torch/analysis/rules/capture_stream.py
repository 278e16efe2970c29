"""Rule ``graph-capture-stream`` — every CUDA-graph capture names its
stream; the port's counterpart of ``repro.analysis.rules.jit_static``.

The reference asks every ``jax.jit`` for an explicit static/donate
decision, because the fused engine's performance rests on it.  The
port's fused engine rests on its captures instead (``engine/fused.py``),
and a capture's decision is its stream: the first chunk of a length runs
eagerly on the stream that then captures it, so that cuBLAS's workspace
for that stream exists before capture, and every fused engine of a
device shares one such side stream, because cuBLAS keeps a workspace for
each stream it has run on (64 MiB on an H100) until the workspaces are
cleared.  A ``torch.cuda.graph(g)`` without ``stream=`` captures on
torch's own default capture stream instead, which the warm-up did not
run on.  The rule requires ``stream=`` (or the third positional
argument) at every ``torch.cuda.graph`` call.
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
_STREAM_POSITION = 2  # torch.cuda.graph(cuda_graph, pool=None, stream=None, ...)


@register_rule
class GraphCaptureStream(Rule):
    name = "graph-capture-stream"
    description = (
        "every torch.cuda.graph capture states its stream (stream=): the "
        "warm-up must run on the stream that captures"
    )

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Violation]:
        aliases = resolve_aliases(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if canonical_call_name(node.func, aliases) not in _GRAPH_NAMES:
                continue
            if len(node.args) > _STREAM_POSITION or any(
                    k.arg == "stream" for k in node.keywords):
                continue
            yield self.violation(
                ctx, node,
                "torch.cuda.graph without stream=: capture on the stream the "
                "warm-up ran on (the fused engines share one a device), not on "
                "torch's default capture stream",
            )
