"""Federated tasks, ported from ``repro.engine.tasks`` (this slice:
``classification``).

A ``Task`` owns everything workload-specific that the round protocol
needs: the per-example partition labels, the client histograms used for
clustering, the model initialisation and the ``(apply_fn, loss_fn,
metric_fn)`` triple with the contract
``loss_fn(apply_fn(params, x), y, weights)``.  ``params`` is the flat
(P,) vector or an (m, P) cohort.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from repro_torch.data.partition import label_histograms
from repro_torch.engine.registry import TASK_REGISTRY, register_task
from repro_torch.models.mlp import MLPLayout, accuracy, cross_entropy_loss, mlp_apply

__all__ = ["Task", "ClassificationTask", "build_task"]


class Task:
    """Workload contract consumed by ``Engine``.  Subclasses register
    with ``@register_task("name")`` and take ``(cfg, **task_kwargs)``."""

    name = "base"

    def __init__(self, cfg: Any):
        self.cfg = cfg

    def partition_labels(self, train) -> np.ndarray:
        """(N,) integer labels the partitioner splits on."""
        raise NotImplementedError

    def partition_classes(self, n_classes: int) -> int:
        """Cardinality of the partition-label space (HD calibration)."""
        return n_classes

    def client_features(self, train, client_idx, n_classes: int) -> np.ndarray:
        """(K, D) row-normalized histograms used for client clustering."""
        raise NotImplementedError

    def init_params(self, draws, train, n_classes: int):
        raise NotImplementedError

    def build_fns(self, train, n_classes: int) -> tuple[Callable, Callable, Callable]:
        """``(apply_fn, loss_fn, metric_fn)``."""
        raise NotImplementedError


@register_task("classification")
class ClassificationTask(Task):
    """The paper's workload: MLP over class-conditional image features,
    clients clustered by label histograms."""

    name = "classification"

    def _sizes(self, train, n_classes: int) -> tuple[int, ...]:
        return (train.x.shape[1], *self.cfg.hidden, n_classes)

    def partition_labels(self, train) -> np.ndarray:
        return np.asarray(train.y)

    def client_features(self, train, client_idx, n_classes: int) -> np.ndarray:
        return label_histograms(np.asarray(train.y), client_idx, n_classes)

    def init_params(self, draws, train, n_classes: int):
        return draws.init_params(self._sizes(train, n_classes))

    def build_fns(self, train, n_classes: int):
        layout = MLPLayout(self._sizes(train, n_classes))

        def apply_fn(params, x):
            return mlp_apply(layout.views(params), x)

        return apply_fn, cross_entropy_loss, accuracy


def build_task(cfg) -> Task:
    return TASK_REGISTRY[cfg.task](cfg, **cfg.task_kwargs)
