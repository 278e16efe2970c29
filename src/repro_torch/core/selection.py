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
the reference, so selections are identical.  ``fedlecc_select_mask`` is
the counterpart of ``fedlecc_select_jax``: the same algorithm as torch
ops on the losses' device, with static shapes and no host read (no
``.item()``, ``nonzero`` or ``unique``), so it runs inside a captured
round chunk.  ``selection_weights`` turns a participation mask into
FedAvg weights and ``cohort_indices`` into the cohort's client indices.

Every ranking here is a stable sort: ``jax.lax.top_k`` and the
reference's stable argsorts break ties to the lowest index, and
``torch.topk`` on CUDA promises no tie order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["fedlecc_select", "fedlecc_select_mask", "selection_weights", "cohort_indices",
           "top_m_mask"]


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


def _stable_order(x: torch.Tensor, descending: bool) -> torch.Tensor:
    return torch.sort(x, descending=descending, stable=True).indices


def top_m_mask(scores: torch.Tensor, m: int) -> torch.Tensor:
    """(K,) bool mask of the ``m`` highest scores, ties to the lowest
    index (``jax.lax.top_k``'s order)."""
    take = _stable_order(scores, descending=True)[:m]
    return torch.zeros(scores.shape, dtype=torch.bool, device=scores.device).scatter_(0, take, True)


def fedlecc_select_mask(
    labels: torch.Tensor,
    losses: torch.Tensor,
    m: int,
    J: int,
    n_clusters: int,
) -> torch.Tensor:
    """Algorithm 1 as a (K,) boolean participation mask, computed on the
    device of ``labels`` (K,) int64 and ``losses`` (K,) fp32.

    One stable sort orders the clients as Algorithm 1 visits them, by
    the key (phase, r, q): r the rank of the client's cluster by mean
    loss, q the client's loss rank within its cluster, phase 0 for the
    first z = ceil(m / J) members of a top-J cluster, 1 for members of
    the following clusters (the backfill), 2 for the other members of
    the top-J clusters.  The first m are the selection.  ``-inf`` losses
    (the availability gate) are left out of the cluster means, and a
    cluster with no finite member ranks last."""
    losses = losses.to(torch.float32)
    k = losses.shape[0]
    z = -(-m // J)
    dev = losses.device
    onehot = (labels[:, None] == torch.arange(n_clusters, device=dev)).to(torch.float32)
    valid = (losses > -torch.inf).to(torch.float32)
    members = (onehot * valid[:, None]).sum(0)                          # (C,)
    gated = torch.where(valid > 0, losses, 0.0)
    mean_loss = (onehot * gated[:, None]).sum(0) / torch.clamp(members, min=1e-9)
    mean_loss = torch.where(members > 0, mean_loss, -torch.inf)
    order = _stable_order(mean_loss, descending=True)
    rank_of_cluster = torch.empty_like(order).scatter_(
        0, order, torch.arange(n_clusters, device=dev))
    r = rank_of_cluster[labels]                                         # (K,)

    # Within-cluster loss rank q: sort by (r, -loss) with two stable sorts
    p1 = _stable_order(losses, descending=True)
    perm = p1[_stable_order(r[p1], descending=False)]
    sorted_r = r[perm]
    idx = torch.arange(k, device=dev)
    first_pos = torch.full((n_clusters,), k, dtype=torch.int64, device=dev).scatter_reduce(
        0, sorted_r, idx, reduce="amin")
    q = torch.empty_like(idx).scatter_(0, perm, idx - first_pos[sorted_r])

    top = r < J
    phase = torch.where(top & (q < z), 0, torch.where(~top, 1, 2))
    base = k + 1
    key = (phase * base + r) * base + q
    take = _stable_order(key, descending=False)[:m]
    return torch.zeros(k, dtype=torch.bool, device=dev).scatter_(0, take, True)


def cohort_indices(selected_mask: torch.Tensor, m: int) -> torch.Tensor:
    """(m,) int64 sorted client indices of the participation mask, with
    no host read: a stable sort of ``~mask`` puts the selected clients
    first, in index order.  Matches ``np.where(mask)[0]`` for masks with
    exactly ``m`` entries (every strategy's); a mask with fewer pads with
    the lowest unselected indices, which ``selection_weights`` gives
    weight zero."""
    return _stable_order((~selected_mask.to(torch.bool)).to(torch.uint8), descending=False)[:m]
