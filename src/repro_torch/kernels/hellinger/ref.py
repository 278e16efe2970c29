"""Plain PyTorch version of the Hellinger strip kernel.

It repeats the kernel's arithmetic: the inner product over classes runs in
index order with a separately rounded multiply and add per class, so on
the card it is bit-identical to ``csrc/hellinger_strip.cu``.  The CPU tests
hold it against the JAX package; ``chip_smoke.py`` holds the kernel
against it.
"""

from __future__ import annotations

import torch

__all__ = ["hellinger_strip_ref"]


def hellinger_strip_ref(rb: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(B, C) x (K, C) fp32 sqrt-histogram panels -> (B, K) fp32 strip
    sqrt(clip(1 - rb @ r.T, 0, 1))."""
    bc = torch.zeros((rb.shape[0], r.shape[0]), dtype=torch.float32, device=rb.device)
    for c in range(rb.shape[1]):
        bc = bc + rb[:, c, None] * r[None, :, c]
    return torch.sqrt(torch.clamp(1.0 - bc, 0.0, 1.0))
