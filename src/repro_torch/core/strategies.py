"""Client-selection strategies behind one interface, ported from
``repro.core.strategies``: the paper's FedLECC and every baseline the
reference registers.

Every strategy implements:

    setup(hists, client_sizes, seed, device)  — one-time server-side
                                                 state (clustering etc.)
    select(rnd, losses, rng) -> (m,) int indices of selected clients
    extra_upload_bytes_per_round()            — selection-protocol
                                                 overhead for ``CommModel``

Selection is host-side numpy: K scalars per round.  Each ``select``
consumes ``rng`` in exactly the reference's calls, with the same
arguments and in the same order, so one seed gives the reference's
selections.  The strategies that cluster (``fedlecc``,
``fedlecc_adaptive``, ``clusterrandom``, ``haccs``) and ``fedcor`` build
the Hellinger matrix at setup on ``device`` (the strip kernel on the
card).  Offline clients arrive as ``-inf`` losses and every strategy
ranks them last, as in the reference; the port has no availability axis
yet, so no engine produces them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.clustering import best_clustering, cluster_label_histograms
from repro_torch.core.hellinger import hellinger_blocked
from repro_torch.core.selection import fedlecc_select
from repro_torch.engine.registry import register_strategy

__all__ = [
    "SelectionStrategy",
    "FedLECC",
    "PowerOfChoice",
    "HACCS",
    "FedCS",
    "FedCLS",
    "FedCor",
    "LossOnly",
    "ClusterRandom",
    "FedLECCAdaptive",
]

_FLOAT_BYTES = 4


@register_strategy("random")
@dataclass
class SelectionStrategy:
    """Extension base: shared setup state + uniform random ``select``
    (top-m over host-drawn uniform scores), registered as ``random``: the
    selection of FedAvg, FedProx, FedNova and FedDyn.

    ``profile_latency`` is the systems layer's per-client round time in
    the reference; it stays ``None`` in the port, which has no systems
    axis yet, so ``haccs`` and ``fedcs`` take their fallbacks."""

    m: int
    name: str = "random"
    needs_losses: bool = False          # does the server poll all clients for loss?
    needs_histograms: bool = False      # one-time label-histogram upload?
    K: int = field(default=0, init=False)
    client_sizes: np.ndarray | None = field(default=None, init=False)
    profile_latency: np.ndarray | None = field(default=None, init=False)

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

    def _top_m(self, scores: np.ndarray) -> np.ndarray:
        """Sorted indices of the m highest float32 scores, ties to the
        lowest index (the stable argsort of the reference)."""
        return np.sort(np.argsort(-scores, kind="stable")[: min(self.m, self.K)])

    def select(self, rnd: int, losses: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        return self._top_m(self._gate_scores(rng.random(self.K), losses))

    def extra_upload_bytes_per_round(self) -> float:
        # Loss scalars polled from all clients each round, if used.
        return float(self.K * _FLOAT_BYTES) if self.needs_losses else 0.0


@register_strategy("fedlecc")
@dataclass
class FedLECC(SelectionStrategy):
    """The paper's strategy: OPTICS clusters of the clients' label
    histograms (Hellinger geometry, strip kernel on the card) + Algorithm 1.

    ``cluster="auto"`` falls back to a k-medoids sweep when the OPTICS
    silhouette is poor (``best_clustering``); ``cluster_method`` records
    which one ran."""

    J: int = 3
    min_samples: int = 3
    eps: float | str = "auto"
    cluster: str = "optics"      # optics | auto
    name: str = "fedlecc"
    needs_losses: bool = True
    needs_histograms: bool = True
    labels: np.ndarray | None = field(default=None, init=False)
    n_clusters: int = field(default=0, init=False)
    cluster_method: str = field(default="optics", init=False)

    def setup(self, hists, client_sizes, seed: int = 0, *, device="cuda") -> None:
        super().setup(hists, client_sizes, seed, device=device)
        if self.cluster == "auto":
            d = hellinger_blocked(np.asarray(hists), device=device)
            self.labels, self.cluster_method = best_clustering(
                d, min_samples=self.min_samples, seed=seed
            )
        else:
            self.labels, _ = cluster_label_histograms(
                hists, min_samples=self.min_samples, eps=self.eps, device=device
            )
        self.n_clusters = int(self.labels.max()) + 1  # J_max from OPTICS

    def _round_J(self, losses: np.ndarray) -> int:
        return min(self.J, self.n_clusters)

    def select(self, rnd, losses, rng) -> np.ndarray:
        return fedlecc_select(self.labels, losses, m=self.m, J=self._round_J(losses))


@register_strategy("poc")
@dataclass
class PowerOfChoice(SelectionStrategy):
    """POC (Cho et al., 2022): sample d candidates ~ p_i (the client
    sizes) without replacement, keep the top-m by float32 loss."""

    d: int = 0  # candidate-set size; 0 -> max(2m, K//5)
    name: str = "poc"
    needs_losses: bool = True

    def _d(self) -> int:
        d = self.d or max(2 * self.m, self.K // 5)
        return min(max(d, self.m), self.K)

    def select(self, rnd, losses, rng) -> np.ndarray:
        p = self.client_sizes / self.client_sizes.sum()
        cand = np.zeros(self.K, bool)
        cand[rng.choice(self.K, size=self._d(), replace=False, p=p)] = True
        return self._top_m(np.where(cand, np.asarray(losses, np.float32), -np.inf))


@register_strategy("haccs")
@dataclass
class HACCS(SelectionStrategy):
    """HACCS (Wolfrath et al., 2022): histogram clusters, latency-efficient
    pick per cluster.  Without a systems profile the latency is the
    reference's placeholder: a fixed lognormal draw per client from
    ``np.random.default_rng(seed)``.

    Clients are visited by one lexicographic key: proportional slots per
    cluster (>= 1 for the largest), the most-populated cluster first and
    the fastest device first within it, then the globally fastest of the
    rest.  Selection ignores losses and draws nothing from ``rng``."""

    min_samples: int = 3
    name: str = "haccs"
    needs_histograms: bool = True
    labels: np.ndarray | None = field(default=None, init=False)
    latency: np.ndarray | None = field(default=None, init=False)
    n_clusters: int = field(default=0, init=False)

    def setup(self, hists, client_sizes, seed: int = 0, *, device="cuda") -> None:
        super().setup(hists, client_sizes, seed, device=device)
        self.labels, _ = cluster_label_histograms(
            hists, min_samples=self.min_samples, device=device
        )
        self.n_clusters = int(self.labels.max()) + 1
        if self.profile_latency is not None:
            self.latency = self.profile_latency
        else:
            self.latency = np.random.default_rng(seed).lognormal(0.0, 0.5, size=self.K)

    def _selection_keys(self) -> np.ndarray:
        """(K,) int sort key: ascending order visits clients exactly as the
        quota algorithm does."""
        counts = np.bincount(self.labels, minlength=self.n_clusters)
        slots = np.maximum(np.round(self.m * counts / counts.sum()).astype(int), 0)
        largest = int(np.argmax(counts))
        if slots[largest] == 0:  # rounding can starve even the largest cluster
            slots[largest] = 1
        crank = np.empty(self.n_clusters, np.int64)  # 0 = most-populated
        crank[np.argsort(-counts, kind="stable")] = np.arange(self.n_clusters)
        q = np.empty(self.K, np.int64)  # latency rank within the own cluster
        for c in range(self.n_clusters):
            members = np.where(self.labels == c)[0]
            q[members[np.argsort(self.latency[members], kind="stable")]] = np.arange(members.size)
        g = np.empty(self.K, np.int64)  # global latency rank
        g[np.argsort(self.latency, kind="stable")] = np.arange(self.K)
        in_quota = q < slots[self.labels]
        return np.where(in_quota, crank[self.labels] * self.K + q, self.K * self.K + g)

    def select(self, rnd, losses, rng) -> np.ndarray:
        keys = self._selection_keys()
        if losses is not None:
            # past every quota (< K²) and fill (< K² + K) key, order kept
            offline = np.asarray(losses, np.float32) == -np.inf
            keys = np.where(offline, keys + 2 * self.K * self.K, keys)
        return np.sort(np.argsort(keys, kind="stable")[: min(self.m, self.K)])


@register_strategy("fedcs")
@dataclass
class FedCS(SelectionStrategy):
    """FedCS-style ranking (Nishio & Yonetani, 2019): the m fastest clients
    by the systems profile's expected round time.  Without a profile the
    scores are all zero, so selection is lowest index first among the
    online clients."""

    name: str = "fedcs"

    def _scores(self) -> np.ndarray:
        if self.profile_latency is None:
            return np.zeros(self.K, np.float32)
        return (-self.profile_latency).astype(np.float32)

    def select(self, rnd, losses, rng) -> np.ndarray:
        return self._top_m(self._gate_scores(self._scores(), losses))


@register_strategy("fedcls")
@dataclass
class FedCLS(SelectionStrategy):
    """FedCLS (Li & Wu, 2022): label presence at ``presence_threshold``;
    greedy selection maximizing label coverage (Hamming gain), ties broken
    by ``rng.choice``; coverage restarts once every label is covered."""

    presence_threshold: float = 0.05
    name: str = "fedcls"
    needs_histograms: bool = True
    presence: np.ndarray | None = field(default=None, init=False)

    def setup(self, hists, client_sizes, seed: int = 0, *, device="cuda") -> None:
        super().setup(hists, client_sizes, seed, device=device)
        h = np.asarray(hists, np.float64)
        h = h / np.maximum(h.sum(1, keepdims=True), 1e-12)
        self.presence = (h >= self.presence_threshold).astype(np.int64)  # (K, C)

    def select(self, rnd, losses, rng) -> np.ndarray:
        # Offline clients score -1, below every online gain (>= 0).
        offline = (
            np.asarray(losses, np.float32) == -np.inf
            if losses is not None else np.zeros(self.K, bool)
        )
        covered = np.zeros(self.presence.shape[1], dtype=np.int64)
        remaining = list(range(self.K))
        selected: list[int] = []
        for _ in range(min(self.m, self.K)):
            gains = np.array(
                [-1 if offline[i] else np.sum(self.presence[i] & (1 - covered))
                 for i in remaining]
            )
            best = np.flatnonzero(gains == gains.max())
            pick = remaining[int(rng.choice(best))]
            selected.append(pick)
            covered = np.minimum(covered + self.presence[pick], 1)
            remaining.remove(pick)
            if covered.all():
                covered[:] = 0  # restart coverage passes
        return np.sort(np.array(selected, dtype=np.int64))


@register_strategy("fedcor")
@dataclass
class FedCor(SelectionStrategy):
    """FedCor (Tang et al., 2022), the reference's lightweight variant: a
    GP prior over client losses with an RBF kernel on the Hellinger
    distances (float32, from the strip kernel on the card), loss-weighted
    in float64; greedy max-posterior-variance picks, offline clients
    ranked last."""

    length_scale: float = 0.3
    noise: float = 1e-2
    name: str = "fedcor"
    needs_losses: bool = True
    needs_histograms: bool = True
    Kmat: np.ndarray | None = field(default=None, init=False)

    def setup(self, hists, client_sizes, seed: int = 0, *, device="cuda") -> None:
        super().setup(hists, client_sizes, seed, device=device)
        d = hellinger_blocked(np.asarray(hists), device=device)
        self.Kmat = np.exp(-(d**2) / (2 * self.length_scale**2))

    def select(self, rnd, losses, rng) -> np.ndarray:
        losses = np.asarray(losses, np.float64)
        offline = losses == -np.inf
        losses = np.where(offline, 0.0, losses)
        prior = self.Kmat * np.outer(losses, losses) / max(losses.max() ** 2, 1e-12)
        var = np.diag(prior).copy()
        cov = prior.copy()
        selected: list[int] = []
        for _ in range(min(self.m, self.K)):
            ranked = np.where(offline, -np.inf, var)
            cand = np.argsort(-ranked, kind="stable")
            pick = next(int(i) for i in cand if int(i) not in selected)
            selected.append(pick)
            denom = cov[pick, pick] + self.noise
            cov = cov - np.outer(cov[:, pick], cov[pick, :]) / denom
            var = np.clip(np.diag(cov).copy(), 0.0, None)
        return np.sort(np.array(selected, dtype=np.int64))


@register_strategy("lossonly")
@dataclass
class LossOnly(SelectionStrategy):
    """Ablation (RQ2): FedLECC without clustering — global top-m by
    float32 loss."""

    name: str = "lossonly"
    needs_losses: bool = True

    def select(self, rnd, losses, rng) -> np.ndarray:
        return self._top_m(np.asarray(losses, np.float32))


@register_strategy("clusterrandom")
@dataclass
class ClusterRandom(FedLECC):
    """Ablation (RQ2): FedLECC without loss guidance — the same OPTICS
    clusters, clusters and members drawn uniformly.  Algorithm 1 runs over
    integer scores composed from a cluster permutation and a client
    permutation, the cluster term dominating."""

    name: str = "clusterrandom"
    needs_losses: bool = False

    def _random_scores(self, rng: np.random.Generator) -> np.ndarray:
        cluster_rank = rng.permutation(self.n_clusters)  # 0 = drawn first
        client_rank = rng.permutation(self.K)
        return (
            (self.n_clusters - cluster_rank[self.labels]) * (self.K + 1)
            + (self.K - client_rank)
        ).astype(np.float64)

    def select(self, rnd, losses, rng) -> np.ndarray:
        scores = self._gate_scores(self._random_scores(rng), losses)
        return fedlecc_select(self.labels, scores, m=self.m, J=min(self.J, self.n_clusters))


@register_strategy("fedlecc_adaptive")
@dataclass
class FedLECCAdaptive(FedLECC):
    """Beyond the paper: J per round from the dispersion of the cluster
    mean losses — the clusters whose mean loss is at least min + 0.5 (max
    − min), clipped to [2, min(m, J_max)]; offline (-inf) members are left
    out of the means."""

    name: str = "fedlecc_adaptive"

    def _round_J(self, losses: np.ndarray) -> int:
        means = []
        for c in np.unique(self.labels):
            ls = losses[self.labels == c]
            ls = ls[ls > -np.inf]
            if ls.size:
                means.append(ls.mean())
        means = np.asarray(means)
        if means.size <= 1:
            return 1
        thr = means.min() + 0.5 * (means.max() - means.min())
        J = int((means >= thr).sum())
        return max(2, min(J, self.m, self.n_clusters))
