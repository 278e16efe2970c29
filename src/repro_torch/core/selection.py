"""Algorithm 1 — cluster- and loss-guided client selection (FedLECC §IV-C).

Ported from ``repro.core.selection``.  Inputs per round: cluster labels
(fixed after the one-time clustering), per-client local empirical losses,
targets ``J`` (clusters) and ``m`` (clients).

  1. z = ceil(m / J)
  2. mean loss per cluster; rank clusters by mean loss (descending)
  3. take top-J clusters; inside each, take the z highest-loss clients
  4. if |S| < m, fill remaining slots with the highest-loss clients from
     the *following* clusters, in descending cluster-mean-loss order

``fedlecc_select`` is host-side numpy with stable argsorts, verbatim from
the reference, so selections are identical.  ``selection_weights`` turns
a participation mask into FedAvg weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["fedlecc_select", "selection_weights"]


def fedlecc_select(
    cluster_labels: np.ndarray,
    losses: np.ndarray,
    m: int,
    J: int,
) -> np.ndarray:
    """Algorithm 1.  Returns sorted int array of selected client indices, |S| = m."""
    cluster_labels = np.asarray(cluster_labels)
    losses = np.asarray(losses, np.float64)
    k = cluster_labels.shape[0]
    m = min(int(m), k)
    clusters = np.unique(cluster_labels)
    J = max(1, min(int(J), clusters.size))
    z = math.ceil(m / J)

    # Mean loss per cluster, clusters ranked descending.  Unavailable
    # clients enter as -inf: they are excluded from the cluster mean, and
    # the descending within-cluster sort visits them dead last.
    def _cluster_mean(c):
        member_losses = losses[cluster_labels == c]
        finite = member_losses > -np.inf
        return member_losses[finite].mean() if finite.any() else -np.inf

    mean_loss = np.array([_cluster_mean(c) for c in clusters])
    ranked = clusters[np.argsort(-mean_loss, kind="stable")]

    selected: list[int] = []
    # Top-J clusters: top-z clients by loss within each.
    for c in ranked[:J]:
        members = np.where(cluster_labels == c)[0]
        take = members[np.argsort(-losses[members], kind="stable")][:z]
        selected.extend(int(i) for i in take)
        if len(selected) >= m:
            break
    selected = selected[:m]

    # Backfill (Algorithm 1 line 13): highest-loss clients from the
    # *following* clusters in descending mean-loss order; if the whole
    # tail is exhausted, fall back to leftover members of the top-J.
    if len(selected) < m:
        chosen = set(selected)
        for c in list(ranked[J:]) + list(ranked[:J]):
            members = np.where(cluster_labels == c)[0]
            for i in members[np.argsort(-losses[members], kind="stable")]:
                if int(i) not in chosen:
                    selected.append(int(i))
                    chosen.add(int(i))
                    if len(selected) >= m:
                        break
            if len(selected) >= m:
                break

    return np.sort(np.array(selected[:m], dtype=np.int64))


def selection_weights(selected_mask: torch.Tensor, client_sizes: torch.Tensor) -> torch.Tensor:
    """FedAvg aggregation weights gated by the participation mask:
    w_i = N_i / sum_{j in S} N_j for i in S, else 0 (float32)."""
    sizes = client_sizes.to(torch.float32)
    gated = torch.where(selected_mask.to(torch.bool), sizes, torch.zeros_like(sizes))
    return gated / torch.clamp(gated.sum(), min=1e-12)
