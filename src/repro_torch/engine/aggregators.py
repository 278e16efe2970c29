"""Server aggregation rules as registered objects, ported from
``repro.engine.aggregators``: ``fedavg``, ``fednova`` and ``feddyn`` (one
FedAvg reduce kernel launch a round each), ``trimmed_mean`` and
``coordinate_median`` (sorts along the client axis).

    init_state(global_params)                      -> state (or None)
    aggregate(stacked, global_params, weights,
              taus, state, n_selected)             -> new global params
    update_state(state, stacked, global_params,
                 weights, n_selected)              -> new state
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.engine.registry import AGGREGATOR_REGISTRY, register_aggregator
from repro_torch.federated.aggregation import (
    coordinate_median,
    fedavg,
    feddyn_server,
    feddyn_update_h,
    fednova,
    trimmed_mean,
)

__all__ = [
    "Aggregator",
    "FedAvgAggregator",
    "FedNovaAggregator",
    "FedDynAggregator",
    "TrimmedMeanAggregator",
    "CoordinateMedianAggregator",
    "get_aggregator",
]


class Aggregator:
    """Base aggregator: stateless, must implement ``aggregate``.
    ``kwarg_names`` declares which ``FLConfig.aggregator_kwargs`` keys a
    rule understands; unknown keys fail at construction."""

    name = "base"
    needs_state = False
    kwarg_names: tuple = ()

    def __init__(self, cfg):
        self.cfg = cfg
        kw = dict(getattr(cfg, "aggregator_kwargs", None) or {})
        unknown = set(kw) - set(self.kwarg_names)
        if unknown:
            raise ValueError(
                f"aggregator {self.name!r} accepts kwargs "
                f"{list(self.kwarg_names)}; unknown: {sorted(unknown)}"
            )
        self.kwargs = kw

    def init_state(self, global_params: Any) -> Any:
        return None

    def aggregate(self, stacked, global_params, weights, taus, state, n_selected: int):
        raise NotImplementedError

    def update_state(self, state, stacked, global_params, weights, n_selected: int):
        return state


@register_aggregator("fedavg")
class FedAvgAggregator(Aggregator):
    """θ ← Σ_i w_i θ_i (weights normalized ∝ N_i over the selected set)."""

    name = "fedavg"

    def aggregate(self, stacked, global_params, weights, taus, state, n_selected: int):
        return fedavg(stacked, weights)


@register_aggregator("fednova")
class FedNovaAggregator(Aggregator):
    """FedNova: τ-normalized client deltas rescaled by τ_eff = Σ w_i τ_i."""

    name = "fednova"

    def aggregate(self, stacked, global_params, weights, taus, state, n_selected: int):
        return fednova(stacked, global_params, weights, taus)


@register_aggregator("feddyn")
class FedDynAggregator(Aggregator):
    """FedDyn server rule with the server ``h`` as aggregator state, a (P,)
    fp32 tensor: ``aggregate`` applies θ ← mean_S θ_i − h/α and
    ``update_state`` accumulates h ← h − α·(m/K)·(mean_S θ_i − θ_g)."""

    name = "feddyn"
    needs_state = True

    def init_state(self, global_params: Any) -> Any:
        return torch.zeros_like(global_params, dtype=torch.float32)

    def aggregate(self, stacked, global_params, weights, taus, state, n_selected: int):
        theta, mean_params = feddyn_server(stacked, weights, state, self.cfg.mu)
        # stash for update_state (called right after in the round loop), so
        # the cohort is reduced once a round
        self._last_mean = mean_params
        return theta

    def update_state(self, state, stacked, global_params, weights, n_selected: int):
        mean_params = getattr(self, "_last_mean", None)
        if mean_params is None:  # update_state called standalone
            mean_params = fedavg(stacked, weights)
        self._last_mean = None
        return feddyn_update_h(state, mean_params, global_params, self.cfg.mu,
                               n_selected / self.cfg.n_clients)


@register_aggregator("trimmed_mean")
class TrimmedMeanAggregator(Aggregator):
    """Robust coordinate-wise β-trimmed mean; ``trim_frac`` in [0, 0.5),
    default 0.2."""

    name = "trimmed_mean"
    kwarg_names = ("trim_frac",)

    def __init__(self, cfg):
        super().__init__(cfg)
        self.trim_frac = float(self.kwargs.get("trim_frac", 0.2))
        if not 0.0 <= self.trim_frac < 0.5:
            raise ValueError(f"trim_frac must be in [0, 0.5), got {self.trim_frac}")

    def aggregate(self, stacked, global_params, weights, taus, state, n_selected: int):
        return trimmed_mean(stacked, weights, self.trim_frac)


@register_aggregator("coordinate_median")
class CoordinateMedianAggregator(Aggregator):
    """Robust coordinate-wise median (client weights ignored)."""

    name = "coordinate_median"

    def aggregate(self, stacked, global_params, weights, taus, state, n_selected: int):
        return coordinate_median(stacked, weights)


def get_aggregator(name: str, cfg) -> Aggregator:
    return AGGREGATOR_REGISTRY[name](cfg)
