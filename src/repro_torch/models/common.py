"""Shared model building blocks, ported from ``repro.models.common``:
norms, activations, RoPE and the LeCun initialiser.

The numerics follow the reference: norms accumulate in fp32 and cast
back, ``layer_norm`` uses the biased variance, ``rms_norm`` scales by
``1 + scale``, ``gelu`` is the tanh approximation (``jax.nn.gelu``'s
default), and RoPE rotates interleaved pairs ``(x0, x1) -> (x0 c - x1 s,
x0 s + x1 c)`` of the leading ``rope_fraction`` of the head dims.

Weights arrive either shared by the whole batch or with a leading client
axis m (a cohort of m models, one per client): ``linear`` and
``per_client`` are the two places where the difference shows.

A rank that holds its blocks of the weights (``sharding.shard_tree``)
computes a layer tensor-parallel over the mesh's ``model`` axis with the
Megatron primitives: ``column_in`` on the activation, replicated over
``model``, that feeds column blocks (the identity forward; backward, the
ranks' partial gradients summed), ``row_out`` on a row block's partial
output (summed over ``model``; backward, the identity), and
``gather_whole`` for a leaf whose split does not fall on a head
boundary: gathered whole over ``model`` for the layer (backward, the
rank's slice of the gradient; with ``partial``, the ranks' gradients
summed first, where each rank uses the whole leaf for its own part).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "rms_norm",
    "layer_norm",
    "activation",
    "rope_table",
    "apply_rope",
    "he_init",
    "lecun_init",
    "linear",
    "per_client",
    "column_in",
    "row_out",
    "gather_whole",
]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
             mesh=None) -> torch.Tensor:
    """RMSNorm with fp32 accumulation; ``scale`` broadcasts over x.
    ``mesh``: x's last axis is a rank's block of channels split over
    ``model``, so the sum of squares is summed over ``model``, forward and
    backward (each rank's block is in every rank's norm)."""
    xf = x.to(torch.float32)
    if mesh is None:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        ss = mesh.grad_sum((xf * xf).sum(-1, keepdim=True), "model")
        var = mesh.all_reduce_sum(ss, "model") / (x.shape[-1] * mesh.shape["model"])
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 accumulation and the biased variance."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps) * scale.to(torch.float32) + bias.to(torch.float32)
    return out.to(x.dtype)


def activation(name: str, x: torch.Tensor, gate: torch.Tensor | None = None) -> torch.Tensor:
    """Gated / plain activations.  ``gate`` present -> gated variants."""
    if name == "swiglu":
        if gate is None:
            raise ValueError("swiglu needs a gate")
        return F.silu(gate) * x
    if name == "geglu":
        if gate is None:
            raise ValueError("geglu needs a gate")
        return F.gelu(gate, approximate="tanh") * x
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return torch.relu(x)
    raise ValueError(f"unknown activation {name!r}")


def rope_table(seq_len: int, dim: int, theta: float, device=None,
               dtype: torch.dtype = torch.float32,
               positions: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(seq_len, dim / 2) sin and cos tables; with ``positions`` (decode)
    the table's row at that position, (1, dim / 2), cut from the whole
    table as the reference's ``dynamic_slice`` cuts it."""
    if dim % 2:
        raise ValueError(f"rope dim must be even, got {dim}")
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    ang = torch.outer(t, freqs)
    sin, cos = torch.sin(ang).to(dtype), torch.cos(ang).to(dtype)
    if positions is not None:
        row = slice(int(positions), int(positions) + 1)
        sin, cos = sin[row], cos[row]
    return sin, cos


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               rope_fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding on the leading ``rope_fraction`` of the head dims
    of x (..., S, H, D), interleaved-pair convention; tables (S', rot / 2)
    with S' >= S."""
    d = x.shape[-1]
    rot = int(d * rope_fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    xf = xr.to(torch.float32).unflatten(-1, (rot // 2, 2))
    x0, x1 = xf[..., 0], xf[..., 1]
    s = sin[: x.shape[-3], None, :].to(torch.float32)
    c = cos[: x.shape[-3], None, :].to(torch.float32)
    y0 = x0 * c - x1 * s
    y1 = x0 * s + x1 * c
    y = torch.stack([y0, y1], dim=-1).flatten(-2).to(x.dtype)
    return torch.cat([y, xp], dim=-1)


def he_init(generator: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    """N(0, 2 / fan_in) fp32 weights drawn from ``generator`` on its device
    (``fan_in`` is ``shape[-2]``)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    w = torch.randn(shape, generator=generator, device=generator.device)
    return w * math.sqrt(2.0 / fan_in)


def lecun_init(generator: torch.Generator, shape: tuple[int, ...],
               fan_in: int | None = None) -> torch.Tensor:
    """N(0, 1 / fan_in) fp32 weights drawn from ``generator`` on its device
    (``fan_in`` defaults to ``shape[-2]``)."""
    fan_in = fan_in or (shape[-2] if len(shape) >= 2 else shape[-1])
    w = torch.randn(shape, generator=generator, device=generator.device)
    return w.mul_(math.sqrt(1.0 / fan_in))  # in place: one fp32 copy of a 15 GB expert leaf


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) times w (d_in, d_out) shared by the whole batch, or
    times w (m, d_in, d_out), one matrix per client, with x (m, ..., d_in).
    The per-client product folds x's middle axes so it runs as one batched
    matrix product (``torch.bmm``) over the client axis."""
    if w.ndim == 2:
        return x @ w
    m, d_in, d_out = w.shape
    return (x.reshape(m, -1, d_in) @ w).reshape(*x.shape[:-1], d_out)


def per_client(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A vector parameter (d,) shared, or (m, d) per client, shaped to
    broadcast over x (..., d) or x (m, ..., d)."""
    if p.ndim == 1:
        return p
    return p.reshape(p.shape[0], *([1] * (x.ndim - 2)), p.shape[-1])


def column_in(x: torch.Tensor, mesh) -> torch.Tensor:
    """The replicated activation that feeds column blocks: ``x`` forward,
    its gradient summed over ``model`` backward (``Mesh.grad_sum``)."""
    return mesh.grad_sum(x, "model")


def row_out(y: torch.Tensor, mesh) -> torch.Tensor:
    """A row block's partial output summed over ``model``
    (``Mesh.all_reduce_sum``; backward, the cotangent passes through)."""
    return mesh.all_reduce_sum(y, "model")


def gather_whole(w: torch.Tensor, mesh, dim: int, partial: bool = False) -> torch.Tensor:
    """A leaf's ``model`` blocks gathered whole along ``dim``
    (``Mesh.all_gather``; backward, the rank's slice of its gradient).
    ``partial``: each rank uses the whole leaf for its own part of a sum,
    so the gradient is summed over ``model`` before it is sliced."""
    w = mesh.all_gather(w, "model", dim=dim)
    return mesh.grad_sum(w, "model") if partial else w
