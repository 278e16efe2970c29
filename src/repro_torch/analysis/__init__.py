"""repro_torch.analysis — "tracecheck" for the port: static and on-device
checks of the engine's capture, sync and mask contracts, ported from
``repro.analysis`` (DESIGN.md §11).

The port's fused engine captures each chunk length as a CUDA graph and
replays it; the compiled round reads the device once; the strategies'
traced masks run inside the capture.  This package checks those
invariants in two layers:

- **AST lint** (``repro_torch.analysis.lint`` + ``.rules``) — the
  reference's rules in their torch meaning over the ``repro_torch``
  tree: global-state RNG (numpy, stdlib and torch's default
  generators), host-sync idioms in code that runs under a CUDA-graph
  capture, capability-flag ↔ method consistency, and an explicit stream
  at every ``torch.cuda.graph``.  Pure ``ast`` — importing this layer
  never imports torch.
- **Contracts** (``repro_torch.analysis.contracts``) — every registered
  mask strategy's ``select_mask`` / ``select_mask_traced`` gives a (K,)
  bool mask on the losses' device, the traced one with no synchronizing
  op (and on ``meta`` tensors where its ops allow); a replay writes into
  its graph's own buffers; each kernel library is loaded once a process,
  each chunk length captured once, and a round or chunk makes exactly
  the host reads it means to make.  The capture and sync budgets run on
  the card only.

CLI: ``python -m repro_torch.analysis`` (exit non-zero on violations,
``--json`` report; ``--device cpu`` off the card).  Suppress a lint
finding with an inline pragma: ``# tracecheck: disable=<rule>[,<rule>]``
on the offending line, or ``# tracecheck: disable-file[=<rules>]`` on a
line of its own.
"""

from repro_torch.analysis.lint import (
    CAPTURED_ENTRY_POINTS,
    HOT_PATH_MODULES,
    LintReport,
    Violation,
    default_root,
    lint_paths,
    lint_source,
    run_lint,
)
from repro_torch.analysis.rules import RULES, rule_catalog

__all__ = [
    "CAPTURED_ENTRY_POINTS",
    "HOT_PATH_MODULES",
    "LintReport",
    "RULES",
    "Violation",
    "default_root",
    "lint_paths",
    "lint_source",
    "rule_catalog",
    "run_lint",
]
