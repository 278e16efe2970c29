"""Server-side aggregation over a stacked cohort, ported from
``repro.federated.aggregation`` (this slice: ``fedavg``).

The cohort is one (m, P) tensor, so the FedAvg reduce is one launch of the
FedAvg reduce kernel per round (``repro_torch.kernels.aggregate``; plain
PyTorch on the CPU), not one per parameter leaf.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.aggregate import masked_weighted_sum

__all__ = ["fedavg"]


def fedavg(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """θ ← Σ_i w_i θ_i over the (m, P) cohort, accumulated in fp32
    (weights normalized ∝ N_i over the selected set)."""
    return masked_weighted_sum(stacked, weights).to(stacked.dtype)
