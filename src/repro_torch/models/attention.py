"""Attention, ported from ``repro.models.attention`` (this slice: GQA with
qk-norm, partial RoPE and the sliding window; MLA and decode come later).

- ``naive_attention`` — materialises S x S scores; the oracle, as in the
  reference.
- ``flash_attention`` — causal attention through the flash-attention
  kernel (``repro_torch.kernels.flash_attention``): CUDA tensors launch the
  hand-written forward kernel and, under autograd, its backward; CPU tensors
  take the kernel's plain version.  The reference's chunk sizes belong to
  its JAX scan and have no counterpart here.
- ``gqa_attention`` — the full-sequence GQA module on ``init_gqa``'s
  parameters, shared by the batch or one set per client.

Sliding-window blending: layer heterogeneity enters through the scalar
``is_global`` flag, as in the reference.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import apply_rope, lecun_init, linear, rms_norm

__all__ = ["init_gqa", "gqa_shapes", "gqa_attention", "naive_attention", "flash_attention"]

_NEG = -1e30


def _mask_val(qpos: torch.Tensor, kpos: torch.Tensor, window: int, is_global) -> torch.Tensor:
    """Additive mask: causal and (global or within the window)."""
    causal = kpos <= qpos
    if window and window > 0:
        ok = causal & (((qpos - kpos) < window) | (is_global > 0))
    else:
        ok = causal
    return torch.where(ok, 0.0, _NEG)


def naive_attention(q, k, v, window: int = 0, is_global=1.0) -> torch.Tensor:
    """Oracle: full S x S scores.  q (B, Sq, H, D), k and v (B, Sk, KV, D)."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32), k.to(torch.float32))
    scores = scores / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    scores = scores + _mask_val(qpos, kpos, window, is_global)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def gqa_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Parameter shapes of one GQA block, in the reference's order."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    shapes = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd), "wo": (h * hd, d)}
    if cfg.qk_norm:
        shapes["q_norm"] = (hd,)
        shapes["k_norm"] = (hd,)
    return shapes


def init_gqa(generator: torch.Generator, cfg) -> dict[str, torch.Tensor]:
    """LeCun-initialised projections (``wo`` with fan-in H * hd), zero
    qk-norm scales; fp32, drawn from ``generator``."""
    shapes = gqa_shapes(cfg)
    p = {name: lecun_init(generator, shapes[name]) for name in ("wq", "wk", "wv")}
    p["wo"] = lecun_init(generator, shapes["wo"], fan_in=shapes["wo"][0])
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(shapes["q_norm"], device=generator.device)
        p["k_norm"] = torch.zeros(shapes["k_norm"], device=generator.device)
    return p


def _project_qkv(p, cfg, x, sin, cos):
    """x (..., S, d) -> q (N, S, H, hd), k and v (N, S, KV, hd), the leading
    axes (client and batch) folded into N."""
    s = x.shape[-2]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = linear(x, p["wq"]).reshape(-1, s, h, hd)
    k = linear(x, p["wk"]).reshape(-1, s, kv, hd)
    v = linear(x, p["wv"]).reshape(-1, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, _head_vec(p["q_norm"], q), cfg.norm_eps)
        k = rms_norm(k, _head_vec(p["k_norm"], k), cfg.norm_eps)
    q = apply_rope(q, sin, cos, cfg.rope_fraction)
    k = apply_rope(k, sin, cos, cfg.rope_fraction)
    return q, k, v


def _head_vec(scale: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """qk-norm scale (hd,) or (m, hd) against the folded (N, S, heads, hd)."""
    if scale.ndim == 1:
        return scale
    m = scale.shape[0]
    return scale.repeat_interleave(t.shape[0] // m, dim=0)[:, None, None, :]


def gqa_attention(p, cfg, x, sin, cos, is_global=1.0) -> torch.Tensor:
    """Full sequence (training, poll and evaluation): x (..., S, d) with
    weights shared, or x (m, B, S, d) with weights one set per client ->
    (..., S, d)."""
    q, k, v = _project_qkv(p, cfg, x, sin, cos)
    o = flash_attention(q, k, v, cfg.sliding_window, is_global)
    return linear(o.reshape(*x.shape[:-1], -1), p["wo"])
