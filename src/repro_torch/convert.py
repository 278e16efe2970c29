"""Conversion between the JAX package's parameters and the port's.

The reference keeps the MLP as a list of layers ``[{"w": (in, out),
"b": (out,)}, ...]`` and the transformer as a tree whose ``"layers"``
leaves are stacked on a leading layer axis; the port keeps either model
as one flat fp32 vector (P,), laid out by ``MLPLayout`` or
``TransformerLayout``.  Arrays cross as numpy, so this module needs
neither JAX nor the reference package.  ``leaf_segments`` says which
stretches of the flat vector make up each of the reference's leaves.

For serving, ``serving_params_from_jax`` carries the reference's
parameter tree over in the config's dtype (a bf16 tree too: each leaf
crosses as float32 numpy, which holds every bf16 value exactly, and is
cast back leaf by leaf), ``blocks_from_jax`` cuts that tree into a
rank's blocks under the baseline policy (storage sharding on a grid), and ``cache_from_jax`` / ``cache_to_numpy``
carry a decode cache both ways, so both packages decode from the same
weights and state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.mlp import MLPLayout
from repro_torch.models.transformer import TransformerLayout, cast_params, param_blocks

__all__ = ["leaf_segments", "params_from_jax", "params_to_numpy",
           "transformer_params_from_jax", "transformer_params_to_numpy",
           "serving_params_from_jax", "blocks_from_jax", "cache_from_jax", "cache_to_numpy"]


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


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def transformer_params_from_jax(tree, cfg) -> torch.Tensor:
    """The reference's transformer tree (numpy or array-like leaves, layer
    leaves stacked on a leading axis) -> flat (P,) fp32 CPU tensor in
    ``TransformerLayout(cfg)``."""
    layers = tree["layers"]
    ported = {k: v for k, v in tree.items() if k != "layers"}
    ported["layers"] = [
        _map_tree(lambda a, i=i: a[i], layers) for i in range(cfg.n_layers)
    ]
    ported = _map_tree(lambda a: torch.from_numpy(np.array(a, np.float32)), ported)
    return TransformerLayout(cfg).flatten(ported)


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def serving_params_from_jax(tree, cfg) -> dict:
    """The reference's transformer tree (array-like leaves of any float
    type, layer leaves stacked on a leading axis) -> the port's serving
    tree (``init_params``'s layout: a list of layer dicts) on the CPU, each
    leaf in the type the reference gives it in a ``cfg.dtype`` model."""
    ported = {k: _f32(v) for k, v in tree.items() if k != "layers"}
    ported["layers"] = [_map_tree(lambda a, i=i: _f32(a[i]), tree["layers"])
                        for i in range(cfg.n_layers)]
    return cast_params(ported, getattr(torch, cfg.dtype))


def blocks_from_jax(tree, cfg, mesh) -> dict:
    """The reference's transformer tree -> this rank's blocks of the port's
    serving tree on ``mesh`` (``serving_params_from_jax``, then
    ``transformer.param_blocks``), on the CPU."""
    return param_blocks(serving_params_from_jax(tree, cfg), cfg, mesh)


def cache_from_jax(cache, cfg) -> dict:
    """A reference decode cache (array-like leaves; xlstm states as
    tuples) -> the port's, on the CPU: k and v in ``cfg.dtype``, the
    recurrent states fp32."""
    def one(name, a):
        return _f32(a).to(getattr(torch, cfg.dtype) if name in ("k", "v") else torch.float32)

    return {k: tuple(one(k, a) for a in v) if isinstance(v, (tuple, list)) else one(k, v)
            for k, v in cache.items()}


def cache_to_numpy(cache) -> dict:
    """The port's decode cache -> float32 numpy arrays in the same
    structure (tuples stay tuples)."""
    def one(t):
        return t.detach().to("cpu", torch.float32).numpy()

    return {k: tuple(one(t) for t in v) if isinstance(v, tuple) else one(v)
            for k, v in cache.items()}


def transformer_params_to_numpy(flat: torch.Tensor, cfg) -> dict:
    """Flat (P,) transformer parameters -> the reference's tree of float32
    numpy arrays, layer leaves stacked on a leading axis."""
    tree = TransformerLayout(cfg).views(flat.detach().to("cpu", torch.float32))
    out = {k: v.numpy().copy() for k, v in tree.items() if k != "layers"}
    layers = tree["layers"]

    def stack(path):
        leaves = []
        for layer in layers:
            node = layer
            for key in path:
                node = node[key]
            leaves.append(node.numpy())
        return np.stack(leaves)

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        return stack(path)

    out["layers"] = build(layers[0], ())
    return out


def leaf_segments(layout) -> list[list[tuple[int, int]]]:
    """The reference's parameter leaves as stretches of the port's flat
    vector: one list of (start, stop) column ranges a leaf.  An MLP's
    ``w`` and ``b`` of each layer are one stretch each; a transformer's
    leaf under ``"layers"`` is stacked over the layers in the reference,
    so it is one stretch a layer here, in layer order."""
    if isinstance(layout, MLPLayout):
        leaves = []
        for off, fan_in, fan_out in layout.layers:
            leaves.append([(off, off + fan_in * fan_out)])
            leaves.append([(off + fan_in * fan_out, off + fan_in * fan_out + fan_out)])
        return leaves
    if isinstance(layout, TransformerLayout):
        stacked: dict[tuple, list[tuple[int, int]]] = {}
        off = 0
        for (path, _), size in zip(layout.entries, layout.sizes):
            key = tuple(k for k in path if not isinstance(k, int))
            stacked.setdefault(key, []).append((off, off + size))
            off += size
        return list(stacked.values())
    raise TypeError(f"no leaf structure for {type(layout).__name__}")
