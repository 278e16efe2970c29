"""Server aggregation rules as registered objects, ported from
``repro.engine.aggregators`` (this slice: ``fedavg``).

    init_state(global_params)                      -> state (or None)
    aggregate(stacked, global_params, weights,
              taus, state, n_selected)             -> new global params
    update_state(state, stacked, global_params,
                 weights, n_selected)              -> new state
"""

from __future__ import annotations

from typing import Any

from repro_torch.engine.registry import AGGREGATOR_REGISTRY, register_aggregator
from repro_torch.federated.aggregation import fedavg

__all__ = ["Aggregator", "FedAvgAggregator", "get_aggregator"]


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


def get_aggregator(name: str, cfg) -> Aggregator:
    return AGGREGATOR_REGISTRY[name](cfg)
