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
selections.

The compiled backend calls two more tiers, as the reference does:

    select_mask(losses, rng) -> (K,) bool mask on the strategy's device
                                (``supports_compiled_selection``; the
                                counterpart of ``select_mask_jax``)
    select_mask_traced(losses, noise) -> (K,) bool mask with no host read
                                (``supports_traced_selection``; runs
                                inside a fused, captured round chunk)

``select_mask`` draws any randomness from ``rng`` exactly as ``select``
does (so host and compiled runs of one seed stay in lockstep) and ranks
on the device; it equals ``select`` for the same inputs and rng state.
``select_mask_traced`` takes its randomness as ``noise``, the tensors
that ``traced_noise`` names and the engine's draws make: ``"uniform"``
scores (``random``), ``"gumbel"`` noise (``poc``'s Gumbel-top-k
candidate draw) or ``"permutations"`` of the clusters and the clients
(``clusterrandom``); ``None`` for the strategies that are deterministic
given the losses (``fedlecc``, ``lossonly``, ``haccs``, ``fedcs``), whose
traced mask is their ``select_mask``.  ``fedlecc_adaptive`` is
compiled-only (its J is a host decision); ``fedcls`` and ``fedcor`` are
host-only.  The strategies that cluster (``fedlecc``,
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
from repro_torch.core.selection import fedlecc_select, fedlecc_select_mask, top_m_mask
from repro_torch.engine.registry import STRATEGY_REGISTRY, register_strategy

__all__ = [
    "SelectionStrategy",
    "UniformRandom",
    "FedLECC",
    "PowerOfChoice",
    "HACCS",
    "FedCS",
    "FedCLS",
    "FedCor",
    "LossOnly",
    "ClusterRandom",
    "FedLECCAdaptive",
    "STRATEGIES",
    "get_strategy",
]

_FLOAT_BYTES = 4


@dataclass
class SelectionStrategy:
    """Extension base: shared setup state + uniform random ``select``
    (top-m over host-drawn uniform scores); ``UniformRandom`` registers it
    as ``random``, the selection of FedAvg, FedProx, FedNova and FedDyn.

    ``profile_latency`` is the systems layer's per-client expected round
    time (``SystemsRuntime.latency_hint``, passed to ``setup`` as
    ``latency``); without a systems config it is ``None`` and ``haccs``
    and ``fedcs`` take their fallbacks.  ``device`` is where the masks are
    built (set by ``setup``)."""

    m: int
    name: str = "random"
    needs_losses: bool = False          # does the server poll all clients for loss?
    needs_histograms: bool = False      # one-time label-histogram upload?
    supports_compiled_selection = True  # has select_mask?
    supports_traced_selection = True    # has select_mask_traced?
    traced_noise = "uniform"            # the noise select_mask_traced takes (None: none)
    K: int = field(default=0, init=False)
    client_sizes: np.ndarray | None = field(default=None, init=False)
    profile_latency: np.ndarray | None = field(default=None, init=False)
    device: torch.device = field(default=torch.device("cpu"), init=False)

    def setup(self, hists: np.ndarray, client_sizes: np.ndarray, seed: int = 0,
              latency: np.ndarray | None = None, *,
              device: str | torch.device = "cuda") -> None:
        self.K = len(client_sizes)
        self.client_sizes = np.asarray(client_sizes)
        self.profile_latency = None if latency is None else np.asarray(latency, np.float64)
        self.device = torch.device(device)

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

    def _losses(self, losses) -> torch.Tensor:
        """The loss vector as (K,) fp32 on the strategy's device."""
        return torch.as_tensor(losses, dtype=torch.float32, device=self.device)

    def _gate(self, scores: torch.Tensor, losses) -> torch.Tensor:
        """``_gate_scores`` on the device: offline clients' scores become
        -inf."""
        if losses is None:
            return scores
        return torch.where(self._losses(losses) == -torch.inf, -torch.inf, scores)

    def _mask_top_m(self, scores: torch.Tensor) -> torch.Tensor:
        return top_m_mask(scores, min(self.m, self.K))

    def select(self, rnd: int, losses: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        return self._top_m(self._gate_scores(rng.random(self.K), losses))

    def select_mask(self, losses, rng=None) -> torch.Tensor:
        if rng is None:
            raise ValueError("random selection draws scores host-side; pass rng")
        scores = torch.as_tensor(rng.random(self.K).astype(np.float32), device=self.device)
        return self._mask_top_m(self._gate(scores, losses))

    def select_mask_traced(self, losses: torch.Tensor, noise) -> torch.Tensor:
        (scores,) = noise  # (K,) fp32 uniforms
        return self._mask_top_m(self._gate(scores, losses))

    def extra_upload_bytes_per_round(self) -> float:
        # Loss scalars polled from all clients each round, if used.
        return float(self.K * _FLOAT_BYTES) if self.needs_losses else 0.0

    # -- checkpoint contract -------------------------------------------
    # Every strategy's setup state (cluster labels, latency, kernel
    # matrices, presence traces, the device tensors built from them) is a
    # function of (hists, sizes, seed, latency), rebuilt when the engine is
    # built, and no strategy changes it in ``select``; per-round randomness
    # is the engine's numpy rng, which the engine checkpoints.  A strategy
    # that keeps state from round to round overrides both hooks; the
    # structure of ``state_dict()`` is the restore's ``like`` tree.
    def state_dict(self) -> dict:
        """Array-valued per-round strategy state to checkpoint ({} for a
        strategy with none, the default)."""
        return {}

    def load_state_dict(self, state: dict) -> None:
        if state:
            raise ValueError(
                f"strategy {self.name!r} is stateless but the checkpoint carries strategy "
                f"state keys {sorted(state)} — override load_state_dict in the strategy "
                f"that wrote them"
            )


@register_strategy("random")
@dataclass
class UniformRandom(SelectionStrategy):
    """Uniform random sampling: the base's top-m over uniform scores,
    drawn host-side from ``rng`` (``select``, ``select_mask``) or taken
    from the engine's draws (``select_mask_traced``)."""


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
    traced_noise = None
    labels: np.ndarray | None = field(default=None, init=False)
    n_clusters: int = field(default=0, init=False)
    cluster_method: str = field(default="optics", init=False)

    def setup(self, hists, client_sizes, seed: int = 0, latency=None, *,
              device="cuda") -> None:
        super().setup(hists, client_sizes, seed, latency, device=device)
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
        self._labels = torch.as_tensor(self.labels, dtype=torch.int64, device=self.device)

    def _round_J(self, losses) -> int:
        return min(self.J, self.n_clusters)

    def _mask_algorithm1(self, scores: torch.Tensor, J: int) -> torch.Tensor:
        return fedlecc_select_mask(self._labels, scores, m=min(self.m, self.K),
                                   J=max(1, min(J, self.n_clusters)), n_clusters=self.n_clusters)

    def select(self, rnd, losses, rng) -> np.ndarray:
        return fedlecc_select(self.labels, losses, m=self.m, J=self._round_J(losses))

    def select_mask(self, losses, rng=None) -> torch.Tensor:
        """Deterministic given the losses; ``rng`` is accepted for the
        protocol."""
        return self._mask_algorithm1(self._losses(losses), self._round_J(losses))

    def select_mask_traced(self, losses: torch.Tensor, noise) -> torch.Tensor:
        """J here is loss-independent, so this is ``select_mask``'s mask
        (``fedlecc_adaptive``, whose J is read from the losses on the
        host, opts out)."""
        return self._mask_algorithm1(self._losses(losses), self.J)


@register_strategy("poc")
@dataclass
class PowerOfChoice(SelectionStrategy):
    """POC (Cho et al., 2022): sample d candidates ~ p_i (the client
    sizes) without replacement, keep the top-m by float32 loss."""

    d: int = 0  # candidate-set size; 0 -> max(2m, K//5)
    name: str = "poc"
    needs_losses: bool = True
    traced_noise = "gumbel"

    def setup(self, hists, client_sizes, seed: int = 0, latency=None, *,
              device="cuda") -> None:
        super().setup(hists, client_sizes, seed, latency, device=device)
        p = torch.as_tensor(self.client_sizes / self.client_sizes.sum(), dtype=torch.float32,
                            device=self.device)
        self._log_p = torch.log(torch.clamp(p, min=1e-30))

    def _d(self) -> int:
        d = self.d or max(2 * self.m, self.K // 5)
        return min(max(d, self.m), self.K)

    def _candidate_mask(self, rng: np.random.Generator) -> np.ndarray:
        """(K,) bool: the d candidates drawn ~ p_i without replacement."""
        p = self.client_sizes / self.client_sizes.sum()
        cand = np.zeros(self.K, bool)
        cand[rng.choice(self.K, size=self._d(), replace=False, p=p)] = True
        return cand

    def select(self, rnd, losses, rng) -> np.ndarray:
        cand = self._candidate_mask(rng)
        return self._top_m(np.where(cand, np.asarray(losses, np.float32), -np.inf))

    def select_mask(self, losses, rng=None) -> torch.Tensor:
        if rng is None:
            raise ValueError("poc selection draws candidates host-side; pass rng")
        cand = torch.as_tensor(self._candidate_mask(rng), device=self.device)
        return self._mask_top_m(torch.where(cand, self._losses(losses), -torch.inf))

    def select_mask_traced(self, losses: torch.Tensor, noise) -> torch.Tensor:
        """Gumbel-top-k: the d largest log p_i + Gumbel noise are a draw of
        d candidates ~ p_i without replacement; then the top m losses
        among them."""
        (gumbel,) = noise
        cand = top_m_mask(self._log_p + gumbel, self._d())
        return self._mask_top_m(torch.where(cand, self._losses(losses), -torch.inf))


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
    traced_noise = None
    labels: np.ndarray | None = field(default=None, init=False)
    latency: np.ndarray | None = field(default=None, init=False)
    n_clusters: int = field(default=0, init=False)

    def setup(self, hists, client_sizes, seed: int = 0, latency=None, *,
              device="cuda") -> None:
        super().setup(hists, client_sizes, seed, latency, device=device)
        self.labels, _ = cluster_label_histograms(
            hists, min_samples=self.min_samples, device=device
        )
        self.n_clusters = int(self.labels.max()) + 1
        if self.profile_latency is not None:
            self.latency = self.profile_latency
        else:
            self.latency = np.random.default_rng(seed).lognormal(0.0, 0.5, size=self.K)
        self._keys = torch.as_tensor(self._selection_keys(), device=self.device)

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

    def select_mask(self, losses, rng=None) -> torch.Tensor:
        keys = self._keys
        if losses is not None:
            keys = torch.where(self._losses(losses) == -torch.inf, keys + 2 * self.K * self.K, keys)
        return self._mask_top_m(-keys)  # the m lowest keys (all distinct)

    def select_mask_traced(self, losses: torch.Tensor, noise) -> torch.Tensor:
        return self.select_mask(losses)


@register_strategy("fedcs")
@dataclass
class FedCS(SelectionStrategy):
    """FedCS-style ranking (Nishio & Yonetani, 2019): the m fastest clients
    by the systems profile's expected round time.  Without a profile the
    scores are all zero, so selection is lowest index first among the
    online clients."""

    name: str = "fedcs"
    traced_noise = None

    def setup(self, hists, client_sizes, seed: int = 0, latency=None, *,
              device="cuda") -> None:
        super().setup(hists, client_sizes, seed, latency, device=device)
        self._scores_t = torch.as_tensor(self._scores(), device=self.device)

    def _scores(self) -> np.ndarray:
        if self.profile_latency is None:
            return np.zeros(self.K, np.float32)
        return (-self.profile_latency).astype(np.float32)

    def select(self, rnd, losses, rng) -> np.ndarray:
        return self._top_m(self._gate_scores(self._scores(), losses))

    def select_mask(self, losses, rng=None) -> torch.Tensor:
        return self._mask_top_m(self._gate(self._scores_t, losses))

    def select_mask_traced(self, losses: torch.Tensor, noise) -> torch.Tensor:
        return self.select_mask(losses)


@register_strategy("fedcls")
@dataclass
class FedCLS(SelectionStrategy):
    """FedCLS (Li & Wu, 2022): label presence at ``presence_threshold``;
    greedy selection maximizing label coverage (Hamming gain), ties broken
    by ``rng.choice``; coverage restarts once every label is covered."""

    presence_threshold: float = 0.05
    name: str = "fedcls"
    needs_histograms: bool = True
    supports_compiled_selection = False  # greedy host loop, no mask
    supports_traced_selection = False
    presence: np.ndarray | None = field(default=None, init=False)

    def setup(self, hists, client_sizes, seed: int = 0, latency=None, *,
              device="cuda") -> None:
        super().setup(hists, client_sizes, seed, latency, device=device)
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
    supports_compiled_selection = False  # iterative GP conditioning, host-only
    supports_traced_selection = False
    Kmat: np.ndarray | None = field(default=None, init=False)

    def setup(self, hists, client_sizes, seed: int = 0, latency=None, *,
              device="cuda") -> None:
        super().setup(hists, client_sizes, seed, latency, device=device)
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
    traced_noise = None

    def select(self, rnd, losses, rng) -> np.ndarray:
        return self._top_m(np.asarray(losses, np.float32))

    def select_mask(self, losses, rng=None) -> torch.Tensor:
        return self._mask_top_m(self._losses(losses))

    def select_mask_traced(self, losses: torch.Tensor, noise) -> torch.Tensor:
        return self.select_mask(losses)


@register_strategy("clusterrandom")
@dataclass
class ClusterRandom(FedLECC):
    """Ablation (RQ2): FedLECC without loss guidance — the same OPTICS
    clusters, clusters and members drawn uniformly.  Algorithm 1 runs over
    integer scores composed from a cluster permutation and a client
    permutation, the cluster term dominating."""

    name: str = "clusterrandom"
    needs_losses: bool = False
    traced_noise = "permutations"

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

    def select_mask(self, losses, rng=None) -> torch.Tensor:
        if rng is None:
            raise ValueError("clusterrandom draws its random scores host-side; pass rng")
        scores = torch.as_tensor(self._random_scores(rng).astype(np.float32), device=self.device)
        return self._mask_algorithm1(self._gate(scores, losses), self.J)

    def select_mask_traced(self, losses: torch.Tensor, noise) -> torch.Tensor:
        """The same integer scores from ``noise``'s cluster and client
        permutations (drawn by the engine's draws, not ``rng``)."""
        cluster_rank, client_rank = noise
        scores = ((self.n_clusters - cluster_rank[self._labels]) * (self.K + 1)
                  + (self.K - client_rank)).to(torch.float32)
        return self._mask_algorithm1(self._gate(scores, losses), self.J)


@register_strategy("fedlecc_adaptive")
@dataclass
class FedLECCAdaptive(FedLECC):
    """Beyond the paper: J per round from the dispersion of the cluster
    mean losses — the clusters whose mean loss is at least min + 0.5 (max
    − min), clipped to [2, min(m, J_max)]; offline (-inf) members are left
    out of the means."""

    name: str = "fedlecc_adaptive"
    # J is read from the losses on the host: a mask, but no traced mask
    supports_traced_selection = False

    def _round_J(self, losses) -> int:
        if isinstance(losses, torch.Tensor):
            losses = losses.cpu().numpy()
        losses = np.asarray(losses)
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


STRATEGIES = STRATEGY_REGISTRY


def get_strategy(name: str, m: int, **kwargs) -> SelectionStrategy:
    """Build a selection strategy by name via the engine registry."""
    return STRATEGY_REGISTRY.build(name, m=m, **kwargs)
