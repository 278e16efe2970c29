"""Server-side aggregation over a stacked cohort, ported from
``repro.federated.aggregation``.

The cohort is one (m, P) tensor.  ``fedavg``, ``fednova`` and
``feddyn_server`` each reduce it with one launch of the FedAvg reduce
kernel (``repro_torch.kernels.aggregate``; plain PyTorch on the CPU) and
leave it unmodified: FedDyn's client update reads it after aggregation.
``trimmed_mean`` and ``coordinate_median`` sort along the client axis
(the reference has no kernel for them either), in column chunks, so the
sort's values and int64 indices stay small beside an LM-width cohort.
Participants are the rows with ``weights > 0``, as in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.aggregate import masked_weighted_sum

__all__ = [
    "fedavg",
    "weighted_delta",
    "fednova",
    "feddyn_server",
    "feddyn_update_h",
    "trimmed_mean",
    "coordinate_median",
]

_SORT_COLUMNS = 1 << 20  # columns a sort chunk: (m, 2^20) values + int64 indices


def fedavg(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """θ ← Σ_i w_i θ_i over the (m, P) cohort, accumulated in fp32
    (weights normalized ∝ N_i over the selected set)."""
    return masked_weighted_sum(stacked, weights).to(stacked.dtype)


def weighted_delta(stacked: torch.Tensor, global_params: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Σ_i w_i (θ_i − θ_g), the update FedAvg applies, as Σ_i w_i θ_i −
    (Σ_i w_i) θ_g: one kernel launch and no (m, P) temporary."""
    w = weights.to(torch.float32)
    return masked_weighted_sum(stacked, w) - w.sum() * global_params.to(torch.float32)


def fednova(stacked: torch.Tensor, global_params: torch.Tensor, weights: torch.Tensor,
            taus: torch.Tensor) -> torch.Tensor:
    """FedNova (Wang et al., 2021): each client's delta normalized by its
    local step count τ_i, rescaled by τ_eff = Σ w_i τ_i:

        θ ← θ_g + τ_eff · (Σ_i w'_i θ_i − (Σ_i w'_i) θ_g),   w'_i = w_i / max(τ_i, 1)

    the reference's Σ_i w'_i (θ_i − θ_g) with the cohort sum taken by one
    kernel launch."""
    w = weights.to(torch.float32)
    taus = taus.to(torch.float32)
    w_norm = w / torch.clamp(taus, min=1.0)
    g = global_params.to(torch.float32)
    d = masked_weighted_sum(stacked, w_norm) - w_norm.sum() * g
    return (g + (w * taus).sum() * d).to(global_params.dtype)


def feddyn_server(stacked: torch.Tensor, weights: torch.Tensor, h_server: torch.Tensor,
                  alpha: float) -> tuple[torch.Tensor, torch.Tensor]:
    """FedDyn server rule (Acar et al., 2021): θ ← mean_S θ_i − h / α.
    Returns (θ, mean_S θ_i); the mean is one kernel launch."""
    mean_params = masked_weighted_sum(stacked, weights)
    theta = (mean_params - h_server / alpha).to(stacked.dtype)
    return theta, mean_params.to(stacked.dtype)


def feddyn_update_h(h_server: torch.Tensor, mean_params: torch.Tensor,
                    global_params: torch.Tensor, alpha: float, frac: float) -> torch.Tensor:
    """h ← h − α · frac · (mean_S θ_i − θ_g), frac the participation fraction."""
    return h_server - alpha * frac * (mean_params.to(torch.float32)
                                      - global_params.to(torch.float32))


def _participants(weights: torch.Tensor) -> tuple[torch.Tensor, int]:
    valid = weights > 0
    return valid, int(valid.sum())


def trimmed_mean(stacked: torch.Tensor, weights: torch.Tensor, trim_frac: float) -> torch.Tensor:
    """Coordinate-wise β-trimmed weighted mean (Yin et al., 2018): per
    coordinate the ``floor(trim_frac · n)`` largest and smallest
    participant values are dropped and the rest averaged with renormalized
    weights.  A stable sort, as the reference's, so tied values keep their
    clients' weights in row order."""
    w = weights.to(torch.float32)
    valid, nv = _participants(w)
    k = int(np.floor(np.float32(trim_frac) * np.float32(nv)))
    rows = stacked.shape[0]
    pos = torch.arange(rows, device=stacked.device)[:, None]
    keep = (pos >= k) & (pos < nv - k)
    out = torch.empty(stacked.shape[1], dtype=stacked.dtype, device=stacked.device)
    for c0 in range(0, stacked.shape[1], _SORT_COLUMNS):
        x = stacked[:, c0:c0 + _SORT_COLUMNS].to(torch.float32)
        xs, order = torch.sort(torch.where(valid[:, None], x, math.inf), dim=0, stable=True)
        ws = w[order]
        num = torch.where(keep, xs * ws, 0.0).sum(0)
        den = torch.clamp(torch.where(keep, ws, 0.0).sum(0), min=1e-12)
        out[c0:c0 + x.shape[1]] = num / den
    return out


def coordinate_median(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise (unweighted) median over the participants; an even
    count averages the two middle order statistics."""
    valid, nv = _participants(weights)
    lo, hi = (nv - 1) // 2, nv // 2
    out = torch.empty(stacked.shape[1], dtype=stacked.dtype, device=stacked.device)
    for c0 in range(0, stacked.shape[1], _SORT_COLUMNS):
        x = stacked[:, c0:c0 + _SORT_COLUMNS].to(torch.float32)
        xs = torch.sort(torch.where(valid[:, None], x, math.inf), dim=0).values
        out[c0:c0 + x.shape[1]] = 0.5 * (xs[lo] + xs[hi])
    return out
