"""``repro_torch.faults`` — fault injection, update validation and client
health for the federated engine, ported from ``repro.faults`` (the
reference's DESIGN.md §14).  Configured by ``FLConfig.faults =
FaultConfig(...)``; ``None`` (the default) builds nothing.

- **Injection** (``models``) — a ``@register_fault`` registry of
  per-client fault models over the flat (m, P) cohort, torch on the
  device, their decisions drawn per (seed, round, client) on the numpy
  ``FAULT_STREAM`` child rng as in the reference.
- **Defense** (``defense``) — the server-side validation gate
  (non-finite screening + quantile norm clipping) in torch with no host
  read, so it runs inside a captured round chunk, plus the robust
  aggregators registered in ``repro_torch.engine.aggregators``.
- **Feedback** (``health``) — the numpy ``ClientHealth``
  quarantine/backoff ledger, fed into selection as a ``-inf`` gate.
"""

from repro_torch.faults.config import FaultConfig
from repro_torch.faults.defense import screen_norms, update_norms, validate_updates
from repro_torch.faults.health import ClientHealth
from repro_torch.faults.models import (
    FAULT_REGISTRY,
    FAULT_STREAM,
    FaultModel,
    build_fault,
    list_faults,
    register_fault,
)
from repro_torch.faults.runtime import FaultInfo, FaultRuntime

__all__ = [
    "FaultConfig",
    "FaultRuntime",
    "FaultInfo",
    "FaultModel",
    "ClientHealth",
    "FAULT_REGISTRY",
    "FAULT_STREAM",
    "register_fault",
    "build_fault",
    "list_faults",
    "validate_updates",
    "update_norms",
    "screen_norms",
]
