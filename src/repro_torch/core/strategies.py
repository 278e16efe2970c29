"""Client-selection strategies behind one interface, ported from
``repro.core.strategies``.

Every strategy implements:

    setup(hists, client_sizes, seed, device)  — one-time server-side
                                                 state (clustering etc.)
    select(rnd, losses, rng) -> (m,) int indices of selected clients
    extra_upload_bytes_per_round()            — selection-protocol
                                                 overhead for ``CommModel``

This slice ports the base class (uniform random ``select``) and the
paper's ``fedlecc``; the other registered strategies of the reference
are still to come.  Selection is host-side numpy: K scalars per round.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.clustering import cluster_label_histograms
from repro_torch.core.selection import fedlecc_select
from repro_torch.engine.registry import register_strategy

__all__ = ["SelectionStrategy", "FedLECC"]

_FLOAT_BYTES = 4


@dataclass
class SelectionStrategy:
    """Extension base: shared setup state + uniform random ``select``."""

    m: int
    name: str = "random"
    needs_losses: bool = False          # does the server poll all clients for loss?
    needs_histograms: bool = False      # one-time label-histogram upload?
    K: int = field(default=0, init=False)
    client_sizes: np.ndarray | None = field(default=None, init=False)

    def setup(self, hists: np.ndarray, client_sizes: np.ndarray, seed: int = 0,
              *, device: str | torch.device = "cuda") -> None:
        self.K = len(client_sizes)
        self.client_sizes = np.asarray(client_sizes)

    @staticmethod
    def _gate_scores(scores: np.ndarray, losses) -> np.ndarray:
        """Push offline clients (-inf loss entries) to the back of a
        float32 score ranking."""
        scores = np.asarray(scores, np.float32)
        if losses is None:
            return scores
        offline = np.asarray(losses, np.float32) == -np.inf
        return np.where(offline, np.float32(-np.inf), scores)

    def select(self, rnd: int, losses: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        gated = self._gate_scores(rng.random(self.K), losses)
        return np.sort(np.argsort(-gated, kind="stable")[: min(self.m, self.K)])

    def extra_upload_bytes_per_round(self) -> float:
        # Loss scalars polled from all clients each round, if used.
        return float(self.K * _FLOAT_BYTES) if self.needs_losses else 0.0


@register_strategy("fedlecc")
@dataclass
class FedLECC(SelectionStrategy):
    """The paper's strategy: OPTICS clusters of the clients' label
    histograms (Hellinger geometry, strip kernel on the card) + Algorithm 1.

    Only ``cluster="optics"`` is ported; the reference's ``"auto"``
    (k-medoids fallback) comes with the rest of the clustering module."""

    J: int = 3
    min_samples: int = 3
    eps: float | str = "auto"
    cluster: str = "optics"
    name: str = "fedlecc"
    needs_losses: bool = True
    needs_histograms: bool = True
    labels: np.ndarray | None = field(default=None, init=False)
    n_clusters: int = field(default=0, init=False)
    cluster_method: str = field(default="optics", init=False)

    def __post_init__(self) -> None:
        if self.cluster != "optics":
            raise ValueError(
                f"repro_torch's fedlecc implements cluster='optics' only; got "
                f"{self.cluster!r}"
            )

    def setup(self, hists, client_sizes, seed: int = 0, *, device="cuda") -> None:
        super().setup(hists, client_sizes, seed, device=device)
        self.labels, _ = cluster_label_histograms(
            hists, min_samples=self.min_samples, eps=self.eps, device=device
        )
        self.n_clusters = int(self.labels.max()) + 1  # J_max from OPTICS

    def _round_J(self, losses: np.ndarray) -> int:
        return min(self.J, self.n_clusters)

    def select(self, rnd, losses, rng) -> np.ndarray:
        return fedlecc_select(self.labels, losses, m=self.m, J=self._round_J(losses))
