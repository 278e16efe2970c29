"""``FLConfig`` — the serialized description of a federated experiment,
field for field the reference's ``repro.engine.config.FLConfig``, so one
``to_dict()`` builds both engines.

Strategies, aggregators, client modes and tasks resolve against the
port's registries, which hold every name the reference registers; the
LM task runs the models the port has (stablelm-3b, hymba-1.5b).
Validation rejects, with a message naming the port, every value it does
not implement yet: a backend other than ``host``, a non-zero
``fuse_rounds`` or ``compress_bits``, and any ``systems``,
``async_mode``, ``faults`` or ``population`` axis.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field, fields
from typing import Any

__all__ = ["FLConfig", "BACKENDS"]

BACKENDS = ("host",)
_PARTITIONS = ("shards", "dirichlet")


def _unported(what: str, got: Any, supported: Any) -> ValueError:
    return ValueError(
        f"repro_torch does not implement {what}={got!r} yet (supported: "
        f"{supported}); the JAX package repro runs it"
    )


@dataclass
class FLConfig:
    n_clients: int = 100
    m: int = 10                    # participants per round
    rounds: int = 150
    local_epochs: int = 1
    batch_size: int = 64
    lr: float = 0.005              # paper: SGD lr=0.005
    strategy: str = "fedlecc"
    strategy_kwargs: dict = field(default_factory=dict)
    aggregator: str = "fedavg"
    aggregator_kwargs: dict = field(default_factory=dict)
    client_mode: str = "plain"
    mu: float = 0.0                # fedprox mu / feddyn alpha
    partition: str = "shards"      # shards | dirichlet
    alpha_dirichlet: float | None = None   # dirichlet: None → calibrate
    target_hd: float = 0.9
    eval_samples: int = 128        # per-client loss-poll subsample
    max_steps_cap: int = 50
    eval_every: int = 5
    seed: int = 0
    hidden: tuple[int, ...] = (200, 200)   # paper MLP (classification task)
    backend: str = "host"
    task: str = "classification"
    task_kwargs: dict = field(default_factory=dict)
    fuse_rounds: int = 0
    compress_bits: int = 0
    systems: Any = None
    async_mode: Any = None
    faults: Any = None
    population: Any = None

    def __post_init__(self) -> None:
        self.hidden = tuple(self.hidden)
        if self.backend not in BACKENDS:
            raise _unported("backend", self.backend, BACKENDS)
        if self.partition not in _PARTITIONS:
            raise ValueError(
                f"partition must be one of {_PARTITIONS}, got {self.partition!r}"
            )
        if self.n_clients < 1:
            raise ValueError(f"n_clients must be >= 1, got {self.n_clients}")
        if not 1 <= self.m <= self.n_clients:
            raise ValueError(
                f"m must be in [1, n_clients={self.n_clients}], got {self.m}"
            )
        if self.rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")
        if self.eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {self.eval_every}")
        for name in ("strategy_kwargs", "task_kwargs", "aggregator_kwargs"):
            if not isinstance(getattr(self, name), dict):
                raise ValueError(f"{name} must be a dict")
        from repro_torch.engine.registry import (
            AGGREGATOR_REGISTRY,
            CLIENT_MODE_REGISTRY,
            STRATEGY_REGISTRY,
            TASK_REGISTRY,
        )

        for reg, name in (
            (STRATEGY_REGISTRY, self.strategy),
            (AGGREGATOR_REGISTRY, self.aggregator),
            (CLIENT_MODE_REGISTRY, self.client_mode),
            (TASK_REGISTRY, self.task),
        ):
            if name not in reg:
                raise ValueError(f"unknown {reg.kind} {name!r}; available: {reg.names()}")
        for name in ("fuse_rounds", "compress_bits"):
            if getattr(self, name) != 0:
                raise _unported(name, getattr(self, name), (0,))
        for name in ("systems", "async_mode", "faults", "population"):
            if getattr(self, name) is not None:
                raise _unported(name, getattr(self, name), (None,))
        # Components validate their kwargs when built (cheap: no state).
        from repro_torch.engine.aggregators import get_aggregator
        from repro_torch.engine.tasks import build_task

        try:
            build_task(self)
        except (TypeError, KeyError) as e:  # unknown task kwarg / model name
            raise ValueError(f"invalid task_kwargs for task {self.task!r}: {e}") from None
        get_aggregator(self.aggregator, self)
        try:
            STRATEGY_REGISTRY.build(self.strategy, m=self.m, **self.strategy_kwargs)
        except TypeError as e:  # unknown strategy kwarg
            raise ValueError(
                f"invalid strategy_kwargs for strategy {self.strategy!r}: {e}"
            ) from None

    def to_dict(self) -> dict:
        """JSON-safe dict (tuples become lists; round-trips via from_dict)."""
        d = asdict(self)
        d["hidden"] = list(self.hidden)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FLConfig":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown FLConfig keys: {sorted(unknown)}")
        kw = dict(d)
        if "hidden" in kw:
            kw["hidden"] = tuple(kw["hidden"])
        return cls(**kw)
