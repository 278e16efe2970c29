"""Quantized cohort uploads, ported from ``repro.federated.compression``.

Each selected client's delta θ_i − θ_g is quantized to ``bits`` (int8 at
8) with a symmetric scale per (client, leaf) — the leaves are the
reference's parameter leaves, stretches of the flat vector that
``repro_torch.convert.leaf_segments`` names — and stochastic rounding,
so the error is zero-mean across clients and rounds.  The server adds
the weighted sum of the dequantized deltas to θ_g:

    θ ← θ_g + Σ_i w_i · deq(quant(θ_i − θ_g))

The cohort is quantized in its own (m, P) buffer, stretch by stretch
(the temporaries are one stretch's size), and the weighted sum is one
launch of the FedAvg reduce kernel (plain PyTorch on the CPU).  The
uniforms of the rounding come from the caller, column block by column
block (``Draws.quant_uniforms``), so a test can feed the reference's.

``quantize_delta`` / ``dequantize_delta`` do the same for one flat delta
(P,), leaf by leaf: int8 values and one fp32 scale a leaf
(``QuantizedTree``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.kernels.aggregate import masked_weighted_sum

__all__ = ["QuantizedTree", "quantize_delta", "dequantize_delta", "compressed_fedavg",
           "bytes_per_param"]


class QuantizedTree(NamedTuple):
    q: torch.Tensor      # (P,) int8
    scale: torch.Tensor  # (n_leaves,) fp32, one a leaf


def bytes_per_param(bits: int = 8) -> float:
    return bits / 8.0


def quantize_delta(delta: torch.Tensor, uniforms: torch.Tensor,
                   leaves: list[list[tuple[int, int]]], bits: int = 8) -> QuantizedTree:
    """Symmetric quantization of a flat (P,) delta with a scale a leaf
    (``leaf_segments``) and stochastic rounding: an element rounds up when
    its (P,) uniform lies below its fraction."""
    qmax = 2 ** (bits - 1) - 1
    x = delta.to(torch.float32)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = []
    for leaf in leaves:
        cols = torch.cat([torch.arange(a, b, device=x.device) for a, b in leaf])
        scale = torch.clamp(x[cols].abs().max(), min=1e-12) / qmax
        y = x[cols] / scale
        lo = torch.floor(y)
        up = (uniforms[cols] < y - lo).to(torch.float32)
        q[cols] = torch.clamp(lo + up, -qmax - 1, qmax).to(torch.int8)
        scales.append(scale)
    return QuantizedTree(q, torch.stack(scales))


def dequantize_delta(qt: QuantizedTree, leaves: list[list[tuple[int, int]]]) -> torch.Tensor:
    """The (P,) fp32 delta that ``qt`` encodes."""
    out = qt.q.to(torch.float32)
    for leaf, scale in zip(leaves, qt.scale):
        for start, stop in leaf:
            out[start:stop] *= scale
    return out


def compressed_fedavg(
    stacked: torch.Tensor,                              # (m, P) fp32 cohort, overwritten
    global_params: torch.Tensor,                        # (P,)
    weights: torch.Tensor,                              # (m,) fp32
    uniforms: Callable[[int, int], torch.Tensor],       # (start, stop) -> (m, stop - start)
    leaves: list[list[tuple[int, int]]],
    bits: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (new global params (P,), mean |deq − delta|), the error
    averaged over each leaf's elements and then over the leaves, as the
    reference's.  ``stacked`` ends holding the dequantized deltas."""
    if stacked.dtype != torch.float32:
        raise TypeError(f"the cohort must be float32; got {stacked.dtype}")
    qmax = 2 ** (bits - 1) - 1
    g = global_params.to(torch.float32)
    stacked.sub_(g)
    errs = []
    for leaf in leaves:
        # the scale of each client's leaf: its largest |delta| over the stretches
        amax = None
        for start, stop in leaf:
            lo, hi = torch.aminmax(stacked[:, start:stop], dim=1)
            piece = torch.maximum(-lo, hi)
            amax = piece if amax is None else torch.maximum(amax, piece)
        scale = (torch.clamp(amax, min=1e-12) / qmax)[:, None]
        err = 0.0
        for start, stop in leaf:
            y = stacked[:, start:stop].div_(scale)
            q = torch.floor(y)
            y.sub_(q)                                # the fraction y − floor(y)
            up = uniforms(start, stop).lt_(y)        # round up with that probability
            err = err + (y.sub_(up).abs_() * scale).sum()  # |y − q| · scale
            q.add_(up).clamp_(-qmax - 1, qmax)
            y.copy_(q.mul_(scale))                   # the dequantized delta
        numel = sum(stop - start for start, stop in leaf)
        errs.append(err / (stacked.shape[0] * numel))
    new = g + masked_weighted_sum(stacked, weights)
    return new.to(global_params.dtype), torch.stack(errs).mean()
