"""Plain PyTorch version of the FedAvg reduce kernel.

It repeats the kernel's arithmetic: rows are accumulated in index order in
fp32 with a separately rounded multiply and add, so on the card it is
bit-identical to ``csrc/fedavg_reduce.cu``.
"""

from __future__ import annotations

import torch

__all__ = ["masked_weighted_sum_ref"]


def masked_weighted_sum_ref(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stacked (M, N) fp32/bf16, weights (M,) fp32 -> (N,) fp32
    sum_m w_m * x_m."""
    acc = torch.zeros(stacked.shape[1], dtype=torch.float32, device=stacked.device)
    for i in range(stacked.shape[0]):
        acc = acc + weights[i] * stacked[i].to(torch.float32)
    return acc
