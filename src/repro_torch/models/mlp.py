"""The paper's model: MLP with two hidden layers of 200 neurons (§V-A),
ported from ``repro.models.mlp``.

Parameters live in one flat fp32 vector (P,) — layer by layer ``w`` (in,
out) row-major then ``b`` (out,) — and a cohort of m client models is one
(m, P) tensor.  ``MLPLayout.views`` cuts either into per-layer views
without copying, and ``mlp_apply`` runs the forward on them: a plain
matrix product for one model, a batched one (``torch.bmm`` under
``torch.matmul``) over per-client (m, in, out) views for a cohort.
"""

from __future__ import annotations

import math

import torch

__all__ = ["MLPLayout", "init_mlp", "mlp_apply", "cross_entropy_loss", "accuracy"]


class MLPLayout:
    """Where each layer's ``w`` and ``b`` sit in the flat parameter vector."""

    def __init__(self, sizes: tuple[int, ...]):
        self.sizes = tuple(int(s) for s in sizes)
        self.layers: list[tuple[int, int, int]] = []  # (offset, fan_in, fan_out)
        off = 0
        for fan_in, fan_out in zip(self.sizes[:-1], self.sizes[1:]):
            self.layers.append((off, fan_in, fan_out))
            off += fan_in * fan_out + fan_out
        self.n_params = off

    def views(self, flat: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """[(w, b)] views of a (..., P) parameter tensor: w (..., in, out),
        b (..., out)."""
        if flat.shape[-1] != self.n_params:
            raise ValueError(
                f"parameter vector has {flat.shape[-1]} entries; layout {self.sizes} "
                f"needs {self.n_params}"
            )
        lead = flat.shape[:-1]
        out = []
        for off, fan_in, fan_out in self.layers:
            w = flat[..., off: off + fan_in * fan_out].view(*lead, fan_in, fan_out)
            b = flat[..., off + fan_in * fan_out: off + fan_in * fan_out + fan_out]
            out.append((w, b))
        return out


def init_mlp(generator: torch.Generator,
             sizes: tuple[int, ...] = (784, 200, 200, 10)) -> torch.Tensor:
    """He-initialized flat parameter vector (P,) fp32, drawn from
    ``generator`` on its device: w ~ N(0, 2 / fan_in), b = 0."""
    layout = MLPLayout(sizes)
    device = generator.device
    flat = torch.zeros(layout.n_params, dtype=torch.float32, device=device)
    for (w, _), (_, fan_in, fan_out) in zip(layout.views(flat), layout.layers):
        w.copy_(torch.randn((fan_in, fan_out), generator=generator, device=device)
                * math.sqrt(2.0 / fan_in))
    return flat


def mlp_apply(layers: list[tuple[torch.Tensor, torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
    """Forward pass; ReLU hidden activations, raw logits out.  ``layers``
    from ``MLPLayout.views``: one model with x (..., F), or a cohort of m
    models with x (m, B, F)."""
    h = x
    for w, b in layers[:-1]:
        h = torch.relu(h @ w + b.unsqueeze(-2))
    w, b = layers[-1]
    return h @ w + b.unsqueeze(-2)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE over the last batch axis (optionally sample-weighted):
    logits (..., B, C), labels (..., B) -> (...)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.to(torch.int64).unsqueeze(-1)).squeeze(-1)
    if weights is None:
        return nll.mean(-1)
    w = weights.to(torch.float32)
    return (nll * w).sum(-1) / torch.clamp(w.sum(-1), min=1e-9)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of correct argmax predictions over the last batch axis."""
    return (logits.argmax(-1) == labels).to(torch.float32).mean(-1)
