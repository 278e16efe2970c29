"""``FaultConfig`` — the validated, JSON-safe slot behind
``FLConfig.faults``, ported from ``repro.faults.config`` (the reference's
DESIGN.md §14).

Mirrors the ``SystemsConfig`` contract: plain scalars/strings/kwargs
dicts that survive ``FLConfig.to_dict()``/``from_dict`` round-tripping,
with eager validation — fault-model names resolve against the registry
and every model is built once at config construction so a typo or bad
kwarg fails before any data is touched.  ``FLConfig.faults = None``
(the default) keeps the engine bit-identical to a build without this
subsystem.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, fields

__all__ = ["FaultConfig"]

_DEFENSES = ("none", "validate")


@dataclass
class FaultConfig:
    """The fault axis of one federated experiment.

    - ``rate`` — per-(round, client) probability of injecting a fault,
      drawn on the dedicated ``FAULT_STREAM`` child rng (``rate=0``
      exercises the whole machinery while perturbing nothing).
    - ``models`` / ``model_kwargs`` — registered fault models to mix
      (a hit picks one uniformly) and their per-model constructor
      kwargs, e.g. ``{"exploding": {"eta": 50.0}}``.
    - ``defense`` — ``"none"`` or ``"validate"`` (non-finite screening +
      norm clipping at ``clip_quantile`` of cohort norms, flagging past
      ``norm_tolerance`` × that threshold).
    - ``quarantine_rounds`` / ``backoff`` / ``max_backoff_exp`` /
      ``fail_threshold`` — the ``ClientHealth`` ledger: after
      ``fail_threshold`` consecutive flags a client sits out
      ``quarantine_rounds · backoff**strikes`` rounds (0 disables
      quarantine entirely).
    - ``seed`` — fault-stream seed; ``None`` inherits the engine seed.
    """

    rate: float = 0.0
    models: tuple = ("sign_flip",)
    model_kwargs: dict = field(default_factory=dict)
    defense: str = "none"
    clip_quantile: float = 0.9
    norm_tolerance: float = 3.0
    quarantine_rounds: int = 2
    backoff: float = 2.0
    max_backoff_exp: int = 6
    fail_threshold: int = 1
    seed: int | None = None

    def __post_init__(self) -> None:
        from repro_torch.faults.models import build_fault, list_faults

        if not (
            isinstance(self.rate, (int, float))
            and math.isfinite(self.rate)
            and 0.0 <= self.rate <= 1.0
        ):
            raise ValueError(f"fault rate must be in [0, 1], got {self.rate!r}")
        self.rate = float(self.rate)
        if isinstance(self.models, str):
            self.models = [self.models]
        self.models = list(self.models)
        if not self.models:
            raise ValueError("FaultConfig.models must name at least one model")
        if len(set(self.models)) != len(self.models):
            raise ValueError(f"duplicate fault models: {self.models}")
        known = list_faults()
        for name in self.models:
            if name not in known:
                raise ValueError(
                    f"unknown fault model {name!r}; available: {known}"
                )
        if not isinstance(self.model_kwargs, dict):
            raise ValueError("model_kwargs must be a {model: kwargs} dict")
        for name, kw in self.model_kwargs.items():
            if name not in self.models:
                raise ValueError(
                    f"model_kwargs for {name!r} but it is not in models="
                    f"{self.models}"
                )
            if not isinstance(kw, dict):
                raise ValueError(f"model_kwargs[{name!r}] must be a dict")
        # Eager build: constructor kwargs validated now, not mid-round.
        for name in self.models:
            build_fault(name, **self.model_kwargs.get(name, {}))
        if self.defense not in _DEFENSES:
            raise ValueError(
                f"unknown defense {self.defense!r}; available: {list(_DEFENSES)}"
            )
        if not (0.0 < self.clip_quantile <= 1.0):
            raise ValueError(
                f"clip_quantile must be in (0, 1], got {self.clip_quantile}"
            )
        self.clip_quantile = float(self.clip_quantile)
        if not self.norm_tolerance >= 1.0:
            raise ValueError(
                f"norm_tolerance must be >= 1, got {self.norm_tolerance}"
            )
        self.norm_tolerance = float(self.norm_tolerance)
        if not (isinstance(self.quarantine_rounds, int) and self.quarantine_rounds >= 0):
            raise ValueError(
                f"quarantine_rounds must be an int >= 0, got "
                f"{self.quarantine_rounds!r}"
            )
        if not self.backoff >= 1.0:
            raise ValueError(f"backoff must be >= 1, got {self.backoff}")
        self.backoff = float(self.backoff)
        if not (isinstance(self.max_backoff_exp, int) and self.max_backoff_exp >= 0):
            raise ValueError(
                f"max_backoff_exp must be an int >= 0, got "
                f"{self.max_backoff_exp!r}"
            )
        if not (isinstance(self.fail_threshold, int) and self.fail_threshold >= 1):
            raise ValueError(
                f"fail_threshold must be an int >= 1, got "
                f"{self.fail_threshold!r}"
            )
        if self.seed is not None and not isinstance(self.seed, int):
            raise ValueError(f"seed must be an int or None, got {self.seed!r}")

    @property
    def defended(self) -> bool:
        return self.defense != "none"

    @classmethod
    def from_dict(cls, d: dict) -> "FaultConfig":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown FaultConfig keys: {sorted(unknown)}")
        return cls(**d)
