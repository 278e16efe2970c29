"""OPTICS clustering over the Hellinger-distance matrix (FedLECC §IV-B).

Ported from ``repro.core.clustering``; host-side numpy, because the loop
is K sequential steps of O(K) work on a matrix that already lives on the
host (``hellinger_blocked`` returns it there).

- ``optics``           — density ordering + reachability profile.  With a
    precomputed distance matrix and ``max_eps=inf`` the OPTICS expansion
    reduces to a Prim-style loop: repeatedly visit the unprocessed point
    with the smallest reachability and relax every unprocessed point with
    ``max(core_dist(i), D[i, j])``.  The float32 arithmetic and the
    first-occurrence ``argmin`` tie-break are those of the reference, so
    the ordering and the labels are identical.
- ``extract_clusters`` — DBSCAN-equivalent extraction at a cut ``eps``
    (sklearn's ``cluster_optics_dbscan`` rule); ``eps="auto"`` picks the
    cut from the reachability profile.  Noise points become singleton
    clusters so every client stays selectable.
- ``kmedoids`` / ``silhouette_score`` / ``best_clustering`` — the
    k-medoids fallback that fedlecc's ``cluster="auto"`` sweeps when the
    OPTICS silhouette is poor; numpy on the same float32 matrix, with the
    reference's seeded draws, so the labels are identical.
- ``kmedoids_hists`` — k-medoids over distances computed on demand, one
    Hellinger strip (``hellinger_rows``, the strip kernel on the card) at a
    time, never forming the K x K matrix: the population hierarchy's
    clustering past OPTICS's shard limit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.hellinger import hellinger_blocked, hellinger_rows

__all__ = [
    "OpticsResult",
    "optics",
    "extract_clusters",
    "cluster_label_histograms",
    "kmedoids",
    "kmedoids_hists",
    "best_clustering",
    "silhouette_score",
]


class OpticsResult(NamedTuple):
    ordering: np.ndarray        # (K,) int32 — visit order (permutation)
    reachability: np.ndarray    # (K,) float32 — reachability per *point index*
    core_distances: np.ndarray  # (K,) float32


def optics(dist, min_samples: int = 3) -> OpticsResult:
    """OPTICS ordering from a precomputed (K, K) distance matrix, with
    ``max_eps`` infinite (every point is every point's neighbour)."""
    dist = np.asarray(dist, np.float32)
    k = dist.shape[0]
    ms = min(int(min_samples), k)
    # Core distance: distance to the ms-th nearest point, self included
    # (row i of dist has a zero at i, matching sklearn's kneighbors).
    core = np.sort(dist, axis=1)[:, ms - 1]
    reach = np.full((k,), np.inf, np.float32)
    processed = np.zeros((k,), bool)
    ordering = np.zeros((k,), np.int32)
    for t in range(k):
        key = np.where(processed, np.float32(np.inf), reach)
        # Unvisited starts have reach=inf; argmin's first-occurrence
        # tie-break reproduces "next unprocessed in index order".
        i = int(np.argmin(key))
        ordering[t] = i
        processed[i] = True
        new = np.maximum(core[i], dist[i])
        reach = np.where(processed, reach, np.minimum(reach, new))
    return OpticsResult(ordering=ordering, reachability=reach, core_distances=core)


def _auto_eps(res: OpticsResult) -> float:
    """Pick the reachability cut from the profile (largest-gap heuristic):
    sorting the finite reachabilities ascending, the cut goes through the
    largest gap in the upper half — below every separator jump between
    clusters, above every dense plateau inside one."""
    r = np.asarray(res.reachability)
    finite = np.sort(r[np.isfinite(r)])
    if finite.size < 2:
        return float("inf")
    gaps = np.diff(finite)
    lo = finite.size // 2  # never cut inside the dense low region
    upper = gaps[lo:]
    if upper.size == 0 or upper.max() <= 1e-9:
        return float(finite[-1]) + 1e-6  # no structure: single cluster
    g = lo + int(np.argmax(upper))
    return float(0.5 * (finite[g] + finite[g + 1]))


def extract_clusters(res: OpticsResult, eps: float | str = "auto") -> np.ndarray:
    """DBSCAN-equivalent label extraction at reachability cut ``eps``.

    Returns (K,) int labels in [0, n_clusters); noise points are assigned
    fresh singleton cluster ids (FedLECC keeps every client selectable).
    """
    if eps == "auto":
        eps = _auto_eps(res)
    ordering = np.asarray(res.ordering)
    reach = np.asarray(res.reachability)
    core = np.asarray(res.core_distances)

    k = ordering.shape[0]
    labels = np.zeros(k, dtype=np.int64)
    far_reach = reach > eps
    near_core = core <= eps
    # a far-reach near-core point *starts* a new cluster; a far-reach
    # far-core point is noise.
    starts = far_reach[ordering] & near_core[ordering]
    labels[ordering] = np.cumsum(starts) - 1
    labels[far_reach & ~near_core] = -1
    # The first visited point always has reach=inf; cumsum-1 can leave -1
    # for a leading run that is not near_core — normalize below.
    next_id = labels.max() + 1 if labels.max() >= 0 else 0
    for i in np.where(labels < 0)[0]:
        labels[i] = next_id
        next_id += 1
    # Compact ids to 0..n-1 preserving first-appearance order.
    _, labels = np.unique(labels, return_inverse=True)
    return labels.astype(np.int64)


def cluster_label_histograms(
    hists,
    min_samples: int = 3,
    eps: float | str = "auto",
    *,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, OpticsResult]:
    """End-to-end: label histograms -> HD matrix (strip kernel on
    ``device``) -> OPTICS -> cluster labels."""
    d = hellinger_blocked(hists, device=device)
    res = optics(d, min_samples=min_samples)
    return extract_clusters(res, eps=eps), res


def kmedoids(dist: np.ndarray, k: int, seed: int = 0, iters: int = 25) -> np.ndarray:
    """PAM-lite k-medoids over a precomputed distance matrix, with
    k-means++-style seeding from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    n = dist.shape[0]
    k = min(k, n)
    medoids = [int(rng.integers(n))]
    for _ in range(k - 1):
        d_min = dist[:, medoids].min(axis=1)
        p = d_min**2
        p = p / p.sum() if p.sum() > 0 else np.full(n, 1.0 / n)
        medoids.append(int(rng.choice(n, p=p)))
    medoids = np.array(medoids)
    for _ in range(iters):
        labels = np.argmin(dist[:, medoids], axis=1)
        new = medoids.copy()
        for c in range(k):
            members = np.where(labels == c)[0]
            if members.size == 0:
                continue
            within = dist[np.ix_(members, members)].sum(axis=1)
            new[c] = members[int(np.argmin(within))]
        if np.array_equal(new, medoids):
            break
        medoids = new
    return np.argmin(dist[:, medoids], axis=1).astype(np.int64)


def kmedoids_hists(
    hists: np.ndarray, k: int, seed: int = 0, iters: int = 25, *,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """k-medoids over Hellinger distances computed on demand from the
    histograms — O(K·k) memory, never forming the K x K matrix.

    ``kmedoids``'s seeding (k-means++-style on the squared distance to the
    nearest chosen medoid, from ``np.random.default_rng(seed)``), but each
    distance column comes from a ``hellinger_rows`` strip on ``device``
    against the current medoid panel.  One departure from PAM, the
    reference's: the medoid update picks the member nearest the cluster's
    mean histogram (O(|cluster|·C)) instead of minimizing the
    within-cluster distance sum (O(|cluster|²))."""
    return _kmedoids_hists(hists, k, seed, iters,
                           lambda rows, h: hellinger_rows(rows, h, device=device))


def _kmedoids_hists(hists, k: int, seed: int, iters: int, rows_fn) -> np.ndarray:
    """``kmedoids_hists`` with its strip function ``rows_fn(rows, hists)
    -> (B, K) float32`` given, so a test can hand it another package's
    strips."""
    h = np.asarray(hists, np.float32)
    rng = np.random.default_rng(seed)
    n = h.shape[0]
    k = max(1, min(int(k), n))
    medoids = [int(rng.integers(n))]
    d_near = rows_fn(h[medoids[-1:]], h)[0].astype(np.float64)
    for _ in range(k - 1):
        p = d_near**2
        p = p / p.sum() if p.sum() > 0 else np.full(n, 1.0 / n)
        nxt = int(rng.choice(n, p=p))
        medoids.append(nxt)
        d_near = np.minimum(d_near, rows_fn(h[nxt : nxt + 1], h)[0])
    med = np.array(medoids)
    for _ in range(iters):
        labels = np.argmin(rows_fn(h[med], h), axis=0)
        new = med.copy()
        for c in range(k):
            members = np.where(labels == c)[0]
            if members.size == 0:
                continue
            mean_h = h[members].mean(axis=0, keepdims=True)
            new[c] = members[int(np.argmin(rows_fn(mean_h, h[members])[0]))]
        if np.array_equal(new, med):
            break
        med = new
    return np.argmin(rows_fn(h[med], h), axis=0).astype(np.int64)


def best_clustering(
    dist: np.ndarray,
    min_samples: int = 3,
    silhouette_floor: float = 0.2,
    k_range=range(3, 16),
    seed: int = 0,
) -> tuple[np.ndarray, str]:
    """OPTICS first; if its silhouette is poor (no density structure),
    sweep k-medoids over k and keep the best-silhouette clustering.
    Returns (labels, method_used)."""
    labels = extract_clusters(optics(dist, min_samples=min_samples))
    s_opt = silhouette_score(dist, labels)
    if s_opt >= silhouette_floor:
        return labels, "optics"
    best_labels, best_s = labels, s_opt
    for k in k_range:
        if k >= dist.shape[0]:
            break
        lab = kmedoids(dist, k, seed=seed)
        s = silhouette_score(dist, lab)
        if s > best_s:
            best_labels, best_s = lab, s
    return best_labels, "kmedoids" if best_s > s_opt else "optics"


def silhouette_score(dist: np.ndarray, labels: np.ndarray) -> float:
    """Silhouette over a precomputed distance matrix, in float64;
    singleton clusters contribute 0 (sklearn's convention)."""
    dist = np.asarray(dist, np.float64)
    labels = np.asarray(labels)
    k = dist.shape[0]
    uniq = np.unique(labels)
    if uniq.size < 2:
        return 0.0
    s = np.zeros(k)
    for i in range(k):
        mine = labels == labels[i]
        n_mine = mine.sum()
        if n_mine <= 1:
            continue
        a = dist[i, mine].sum() / (n_mine - 1)
        b = min(dist[i, labels == c].mean() for c in uniq if c != labels[i])
        denom = max(a, b)
        s[i] = 0.0 if denom == 0 else (b - a) / denom
    return float(s.mean())
