"""``FLConfig`` — the serialized description of a federated experiment,
field for field the reference's ``repro.engine.config.FLConfig``, so one
``to_dict()`` builds both engines.

Strategies, aggregators, client modes and tasks resolve against the
port's registries, which hold every name the reference registers; the
LM task runs the models the port has.  ``backend`` is ``"host"``,
``"compiled"`` or ``"scaleout"`` (fedavg only, no fault, population or
async axis); ``fuse_rounds > 0`` (the compiled backend's fused chunks)
and ``compress_bits`` in [2, 8] (quantized cohort deltas) follow the
reference's combination rules with its error texts, as do ``systems``
(a ``SystemsConfig`` or its dict form) and ``faults`` (a ``FaultConfig``
or its dict form): ``stale_replay`` and ``track_energy`` are rejected with
``fuse_rounds > 0``; ``async_mode`` (an ``AsyncConfig`` or its dict form)
under ``validate_async_combination``; ``population`` (a
``PopulationConfig`` or its dict form) on ``host`` and ``compiled`` only,
without fused chunks, the async runtime or a per-client state, and with
no more shards than clients.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field, fields
from typing import Any

__all__ = ["FLConfig", "BACKENDS"]

BACKENDS = ("host", "compiled", "scaleout")
_MASK_BACKENDS = ("compiled", "scaleout")  # selection enters the round as a mask
_PARTITIONS = ("shards", "dirichlet")


# The reference's backend-combination error texts, word for word, so a
# config rejected by one package is rejected by the other with the same
# message; ``MaskSelectionMixin._check_mask_backend`` and ``FusedEngine``
# raise them again at engine build.
def mask_backend_strategy_error(strategy: str, backend: str) -> str:
    from repro_torch.engine.registry import mask_selection_strategies

    return (
        f"strategy {strategy!r} has no jit-compatible selection "
        f"(select_mask_jax), required by backend={backend!r}; either use "
        f"backend='host' or one of the strategies that support it: "
        f"{mask_selection_strategies()}"
    )


def mask_backend_client_mode_error(client_mode: str, backend: str) -> str:
    return (
        f"backend={backend!r} supports client_mode='plain' only (got "
        f"{client_mode!r}); per-client state for unselected clients has "
        f"no scale-out analog"
    )


def mask_backend_aggregator_error(aggregator: str) -> str:
    return (
        "backend='scaleout' aggregates inside the mesh round as the "
        f"mask-gated psum (fedavg semantics); got aggregator={aggregator!r} "
        "— use backend='host' or 'compiled' for other server rules"
    )


def fused_strategy_error(strategy: str) -> str:
    from repro_torch.engine.registry import traced_selection_strategies

    return (
        f"fuse_rounds > 0 runs selection fully traced inside one scanned "
        f"round chunk, which strategy {strategy!r} does not support "
        f"(no select_mask_traced); set fuse_rounds=0 or use one of: "
        f"{traced_selection_strategies()}"
    )


def fused_backend_error(backend: str) -> str:
    return (
        f"fuse_rounds > 0 is a compiled-backend execution mode (the round "
        f"chunk is one jitted lax.scan); got backend={backend!r} — use "
        f"backend='compiled' or set fuse_rounds=0"
    )


def fused_aggregator_error(aggregator: str) -> str:
    return (
        "fuse_rounds > 0 aggregates inside the scanned round chunk "
        f"(mask-gated fedavg semantics); got aggregator={aggregator!r} — "
        "use aggregator='fedavg' or set fuse_rounds=0"
    )


def faults_backend_error(backend: str) -> str:
    return (
        "FLConfig.faults injects and screens client updates through the "
        "host/compiled round paths (eager, fused, and async); "
        f"backend={backend!r} has no fault seam — use backend='host' or "
        "'compiled', or set faults=None"
    )


def stale_fused_error() -> str:
    return (
        "fault model 'stale_replay' replays from a host-side cross-round "
        "cache, which the fused scan chunk cannot consult; set "
        "fuse_rounds=0 or drop 'stale_replay' from FaultConfig.models"
    )


def population_backend_error(backend: str) -> str:
    return (
        "FLConfig.population gathers per-round cohorts from a host-side "
        "client store (DESIGN.md §15), which the mesh-resident scaleout "
        f"round cannot consult; backend={backend!r} has no store seam — "
        "use backend='host' or 'compiled', or set population=None"
    )


def population_fused_error() -> str:
    return (
        "FLConfig.population picks resident shards host-side each round "
        "(the shard-level Algorithm 1), which the fused scan chunk cannot "
        "consult mid-scan; set fuse_rounds=0 or population=None"
    )


def population_async_error() -> str:
    return (
        "FLConfig.population assumes the lock-step round loop (resident "
        "shards are chosen per aggregation round); the async runtime's "
        "event clock has no round-resident notion yet — set "
        "async_mode=None or population=None"
    )


def population_client_mode_error(client_mode: str) -> str:
    return (
        "FLConfig.population keeps per-round state cohort-proportional; "
        f"client_mode={client_mode!r} carries a per-client params-shaped "
        "state array (O(K·P), population-proportional by construction) — "
        "use client_mode='plain' or set population=None"
    )


def energy_mode_error(what: str) -> str:
    return (
        "SystemsConfig.track_energy accounts battery spend from each "
        "round's dispatched cohort on the host-side round loop, which "
        f"{what} cannot consult; disable track_energy or drop {what}"
    )


def compress_backend_error(backend: str, aggregator: str) -> str:
    return (
        "compress_bits > 0 quantizes cohort deltas inside the compiled "
        "mask-gated fedavg aggregation; it requires backend='compiled' "
        f"and aggregator='fedavg' (got backend={backend!r}, "
        f"aggregator={aggregator!r})"
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
    backend: str = "host"          # host | compiled | scaleout
    task: str = "classification"
    task_kwargs: dict = field(default_factory=dict)
    fuse_rounds: int = 0           # >0: fused round chunks (compiled only)
    compress_bits: int = 0         # >0: quantized cohort-delta aggregation
    systems: Any = None            # SystemsConfig | dict | None (repro_torch.systems)
    async_mode: Any = None         # AsyncConfig | dict | None (repro_torch.engine.async_config)
    faults: Any = None             # FaultConfig | dict | None (repro_torch.faults)
    population: Any = None         # PopulationConfig | dict | None (repro_torch.population)

    def __post_init__(self) -> None:
        self.hidden = tuple(self.hidden)
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
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
        # Mask-gated backends need a mask-producing selection and the
        # plain client mode, and scaleout's weighted sum is fedavg; fused
        # chunks need a traced selection and the in-chunk fedavg;
        # compression needs the compiled fedavg.
        cls = STRATEGY_REGISTRY[self.strategy]
        if self.backend in _MASK_BACKENDS:
            if not getattr(cls, "supports_compiled_selection", False):
                raise ValueError(mask_backend_strategy_error(self.strategy, self.backend))
            if self.client_mode != "plain":
                raise ValueError(mask_backend_client_mode_error(self.client_mode, self.backend))
        if self.backend == "scaleout" and self.aggregator != "fedavg":
            raise ValueError(mask_backend_aggregator_error(self.aggregator))
        if self.fuse_rounds < 0:
            raise ValueError(f"fuse_rounds must be >= 0 (0 = off), got {self.fuse_rounds}")
        if self.fuse_rounds > 0:
            if self.backend != "compiled":
                raise ValueError(fused_backend_error(self.backend))
            if not getattr(cls, "supports_traced_selection", False):
                raise ValueError(fused_strategy_error(self.strategy))
            if self.aggregator != "fedavg":
                raise ValueError(fused_aggregator_error(self.aggregator))
        if self.compress_bits:
            if not 2 <= self.compress_bits <= 8:
                raise ValueError(
                    f"compress_bits must be 0 (off) or in [2, 8], got {self.compress_bits}"
                )
            if self.backend != "compiled" or self.aggregator != "fedavg":
                raise ValueError(compress_backend_error(self.backend, self.aggregator))
        # The systems and fault axes: the dict form (from_dict, JSON)
        # becomes the validated config object, which checks names and
        # ranges itself.
        from repro_torch.faults.config import FaultConfig
        from repro_torch.systems.config import SystemsConfig

        for name, kind in (("systems", SystemsConfig), ("faults", FaultConfig)):
            value = getattr(self, name)
            if isinstance(value, dict):
                setattr(self, name, kind.from_dict(value))
            elif value is not None and not isinstance(value, kind):
                raise ValueError(
                    f"{name} must be a {kind.__name__}, its dict form, or None; got "
                    f"{type(value).__name__}"
                )
        # The async runtime: the dict form becomes a validated AsyncConfig,
        # then the reference's cross-field rules (backend, fused chunks,
        # aggregator, client mode, systems, deadline, buffer and concurrency).
        if self.async_mode is not None:
            from repro_torch.engine.async_config import AsyncConfig, validate_async_combination

            if isinstance(self.async_mode, dict):
                self.async_mode = AsyncConfig.from_dict(self.async_mode)
            elif not isinstance(self.async_mode, AsyncConfig):
                raise ValueError(
                    f"async_mode must be an AsyncConfig, its dict form, or None; got "
                    f"{type(self.async_mode).__name__}"
                )
            validate_async_combination(self)
        if self.faults is not None:
            if self.backend not in ("host", "compiled"):
                raise ValueError(faults_backend_error(self.backend))
            if self.fuse_rounds > 0 and "stale_replay" in self.faults.models:
                raise ValueError(stale_fused_error())
        # The population axis: the dict form becomes a validated
        # PopulationConfig; the client store and the resident-shard pick
        # live on the lock-step host round loop, which fused chunks and the
        # async runtime cannot consult.
        if self.population is not None:
            from repro_torch.population.config import PopulationConfig

            if isinstance(self.population, dict):
                self.population = PopulationConfig.from_dict(self.population)
            elif not isinstance(self.population, PopulationConfig):
                raise ValueError(
                    f"population must be a PopulationConfig, its dict form, or None; got "
                    f"{type(self.population).__name__}"
                )
            if self.backend not in ("host", "compiled"):
                raise ValueError(population_backend_error(self.backend))
            if self.fuse_rounds > 0:
                raise ValueError(population_fused_error())
            if self.async_mode is not None:
                raise ValueError(population_async_error())
            if self.client_mode != "plain":
                raise ValueError(population_client_mode_error(self.client_mode))
            if self.population.n_shards > self.n_clients:
                raise ValueError(
                    f"population.n_shards={self.population.n_shards} exceeds "
                    f"n_clients={self.n_clients}"
                )
        if self.systems is not None and self.systems.track_energy:
            if self.fuse_rounds > 0:
                raise ValueError(energy_mode_error("fuse_rounds > 0"))
            if self.async_mode is not None:
                raise ValueError(energy_mode_error("async_mode"))
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
