"""Named experiment presets — the paper's method table as registry
entries, ported from ``repro.engine.presets`` with the same names and
values.

A preset pins the four axes (selection strategy, client mode,
aggregator, task) plus their hyperparameters for one named method::

    cfg = get_preset("fedlecc").make_config(n_clients=100, rounds=150)
    engine = make_engine(cfg, train, test, n_classes=10)

``fedlecc_lm`` runs the LM task on its default model, the reduced
xlstm-125m, at d_model 64 and a 128-token vocabulary.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import MappingProxyType
from typing import Mapping

from repro_torch.engine.config import FLConfig
from repro_torch.engine.registry import PRESET_REGISTRY

__all__ = ["ExperimentPreset", "register_preset", "get_preset", "list_presets"]


@dataclass(frozen=True)
class ExperimentPreset:
    """One named method cell of the paper's Tables II/III."""

    name: str
    strategy: str
    client_mode: str = "plain"
    aggregator: str = "fedavg"
    mu: float = 0.0
    strategy_kwargs: Mapping = field(default_factory=dict)
    task: str = "classification"
    task_kwargs: Mapping = field(default_factory=dict)
    description: str = ""
    fast: bool = False   # in the quick benchmark subset?

    def make_config(self, **overrides) -> FLConfig:
        """Build an ``FLConfig`` for this method; kwargs override any
        experiment-level field (n_clients, rounds, seed, ...)."""
        base = dict(
            strategy=self.strategy,
            client_mode=self.client_mode,
            aggregator=self.aggregator,
            mu=self.mu,
            strategy_kwargs=dict(self.strategy_kwargs),
            task=self.task,
            task_kwargs=dict(self.task_kwargs),
        )
        base.update(overrides)
        return FLConfig(**base)


def register_preset(preset: ExperimentPreset) -> ExperimentPreset:
    PRESET_REGISTRY.register(preset.name)(preset)
    return preset


def get_preset(name: str) -> ExperimentPreset:
    return PRESET_REGISTRY[name]


def list_presets(fast_only: bool = False) -> list[str]:
    return [n for n in PRESET_REGISTRY.names() if not fast_only or PRESET_REGISTRY[n].fast]


def _p(**kw) -> ExperimentPreset:
    kw["strategy_kwargs"] = MappingProxyType(dict(kw.get("strategy_kwargs", {})))
    kw["task_kwargs"] = MappingProxyType(dict(kw.get("task_kwargs", {})))
    return register_preset(ExperimentPreset(**kw))


_p(name="fedavg", strategy="random", fast=True,
   description="FedAvg: uniform random selection, plain local SGD")
_p(name="fedprox", strategy="random", client_mode="fedprox", mu=0.01,
   description="FedProx: random selection + proximal local term")
_p(name="fednova", strategy="random", aggregator="fednova",
   description="FedNova: random selection + tau-normalized aggregation")
_p(name="feddyn", strategy="random", client_mode="feddyn",
   aggregator="feddyn", mu=0.1,
   description="FedDyn: random selection + dynamic regularization")
_p(name="haccs", strategy="haccs",
   description="HACCS: histogram clusters, latency-efficient pick")
_p(name="fedcls", strategy="fedcls",
   description="FedCLS: greedy label-coverage selection")
_p(name="fedcor", strategy="fedcor",
   description="FedCor (lightweight): GP posterior variance-reduction")
_p(name="poc", strategy="poc", fast=True,
   description="Power-of-Choice: d candidates ~ p_i, top-m by loss")
# J=10 (z=1: one client per label-mode cluster) is the reference's tuned
# setting on the shards partition
_p(name="fedlecc", strategy="fedlecc", strategy_kwargs={"J": 10}, fast=True,
   description="FedLECC: OPTICS clusters + Algorithm 1 (paper, J=10)")
_p(name="fedlecc_adaptive", strategy="fedlecc_adaptive",
   description="FedLECC with per-round adaptive J (beyond-paper)")
_p(name="fedlecc_lm", strategy="fedlecc", task="lm",
   strategy_kwargs={"J": 3},
   task_kwargs={"overrides": {"d_model": 64, "vocab": 128}},
   description="FedLECC on the federated-LM task (token-histogram clusters)")
