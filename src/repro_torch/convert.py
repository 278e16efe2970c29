"""Conversion between the JAX package's parameters and the port's.

The reference keeps the MLP as a list of layers ``[{"w": (in, out),
"b": (out,)}, ...]``; the port keeps one flat fp32 vector (P,) laid out
by ``repro_torch.models.mlp.MLPLayout``.  Arrays cross as numpy, so this
module needs neither JAX nor the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.mlp import MLPLayout

__all__ = ["params_from_jax", "params_to_numpy"]


def params_from_jax(params) -> torch.Tensor:
    """``[{"w", "b"}, ...]`` numpy (or array-like) layers -> flat (P,)
    fp32 CPU tensor in the port's layout."""
    parts = []
    for layer in params:
        parts.append(np.asarray(layer["w"], np.float32).ravel())
        parts.append(np.asarray(layer["b"], np.float32).ravel())
    return torch.from_numpy(np.concatenate(parts))


def params_to_numpy(flat: torch.Tensor, sizes: tuple[int, ...]) -> list[dict]:
    """Flat (P,) parameters of an MLP with layer ``sizes`` ->
    ``[{"w": (in, out), "b": (out,)}, ...]`` float32 numpy layers."""
    layers = MLPLayout(sizes).views(flat.detach().to("cpu", torch.float32))
    return [{"w": w.numpy().copy(), "b": b.numpy().copy()} for w, b in layers]
