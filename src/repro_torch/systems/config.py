"""``SystemsConfig`` — the validated, JSON-safe slot behind
``FLConfig.systems`` (DESIGN.md §10).

Like ``task_kwargs``, everything here must survive
``FLConfig.to_dict()`` / ``from_dict`` round-tripping, so the fields
are plain scalars, strings, and kwargs dicts; the heavyweight runtime
objects (profiles, availability traces, the clock) are built by
``repro_torch.systems.runtime.SystemsRuntime`` at engine construction.

Validation is eager: preset names resolve against the profile /
availability registries at config construction, so a typo fails before
any data is touched — the same contract ``FLConfig`` gives the four
component registries.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, fields

__all__ = ["SystemsConfig"]


@dataclass
class SystemsConfig:
    """The systems axis of one federated experiment.

    - ``profile`` / ``profile_kwargs`` — registered device-profile
      preset (``uniform`` | ``zipf_compute`` | ``mobile_mix``) and its
      generator kwargs.
    - ``availability`` / ``availability_kwargs`` — registered on/off
      trace model (``always`` | ``bernoulli`` | ``markov``).  Offline
      clients are ``-inf``-gated out of the loss vector before every
      selection call, and dropped (zero aggregation weight) if a
      loss-blind strategy picks them anyway.
    - ``deadline_s`` — per-round wall-clock deadline in simulated
      seconds; reachable clients slower than this are stragglers and
      their updates are dropped.  ``None`` = the server waits for every
      reachable client.
    - ``over_select`` — over-selection factor ≥ 1: the strategy
      dispatches ``ceil(m · over_select)`` clients so the deadline can
      drop stragglers and still aggregate ~m updates.
    - ``jitter_sigma`` — lognormal sigma of per-round compute-time
      noise (0 = deterministic device times).
    - ``track_energy`` — battery accounting: each
      dispatched-and-online client spends
      ``steps · profile.energy_per_step`` mAh per round; a drained
      battery makes the client unavailable (the same ``-inf`` admission
      gate availability uses), and ``RoundResult.metrics`` reports the
      cohort spend.  Off by default — the ledger is extra cross-round
      state the fused / async execution modes reject.
    """

    profile: str = "uniform"
    profile_kwargs: dict = field(default_factory=dict)
    availability: str = "always"
    availability_kwargs: dict = field(default_factory=dict)
    deadline_s: float | None = None
    over_select: float = 1.0
    jitter_sigma: float = 0.0
    track_energy: bool = False

    def __post_init__(self) -> None:
        from repro_torch.systems.profiles import (
            list_availability_models,
            list_profiles,
        )

        if self.profile not in list_profiles():
            raise ValueError(
                f"unknown device profile {self.profile!r}; available: "
                f"{list_profiles()}"
            )
        if self.availability not in list_availability_models():
            raise ValueError(
                f"unknown availability model {self.availability!r}; "
                f"available: {list_availability_models()}"
            )
        for name in ("profile_kwargs", "availability_kwargs"):
            if not isinstance(getattr(self, name), dict):
                raise ValueError(f"{name} must be a dict")
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError(
                f"deadline_s must be positive (or None = no deadline), got "
                f"{self.deadline_s}"
            )
        if not (isinstance(self.over_select, (int, float))
                and math.isfinite(self.over_select) and self.over_select >= 1.0):
            raise ValueError(
                f"over_select must be a finite factor >= 1, got "
                f"{self.over_select!r}"
            )
        self.over_select = float(self.over_select)
        if not self.jitter_sigma >= 0.0:
            raise ValueError(
                f"jitter_sigma must be >= 0, got {self.jitter_sigma}"
            )
        if self.deadline_s is not None:
            self.deadline_s = float(self.deadline_s)
        self.track_energy = bool(self.track_energy)

    def m_effective(self, m: int, n_clients: int) -> int:
        """Dispatched cohort size: ``ceil(m · over_select)``, clipped to
        the population."""
        return min(int(n_clients), max(int(m), math.ceil(m * self.over_select)))

    @classmethod
    def from_dict(cls, d: dict) -> "SystemsConfig":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown SystemsConfig keys: {sorted(unknown)}")
        return cls(**d)
