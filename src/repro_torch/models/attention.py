"""Attention, ported from ``repro.models.attention``: GQA with qk-norm,
partial RoPE and the sliding window, full sequence and decode (MLA comes
later).

- ``naive_attention`` — materialises S x S scores; the oracle, as in the
  reference.
- ``flash_attention`` — causal attention through the flash-attention
  kernel (``repro_torch.kernels.flash_attention``): CUDA tensors launch the
  hand-written forward kernel and, under autograd, its backward; CPU tensors
  take the kernel's plain version.  The reference's chunk sizes belong to
  its JAX scan and have no counterpart here.
- ``gqa_attention`` — the full-sequence GQA module on ``init_gqa``'s
  parameters, shared by the batch or one set per client; it also returns
  the rotated k and v, a prefill's decode cache.
- ``decode_attention`` — one query position against a KV cache: fp32
  scores over the whole cache, masked past ``pos`` and by the window, in
  plain PyTorch (the reference computes it in ``jnp``, outside any Pallas
  kernel).
- ``gqa_decode`` — one token of the GQA module: its k and v are written
  into the cache at ``pos`` in place (nothing is traced or donated here,
  so no copy of the cache is made), then ``decode_attention``.

Sliding-window blending: layer heterogeneity enters through the scalar
``is_global`` flag, as in the reference.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import apply_rope, lecun_init, linear, rms_norm

__all__ = ["init_gqa", "gqa_shapes", "gqa_attention", "gqa_decode", "naive_attention",
           "flash_attention", "decode_attention"]

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


def gqa_attention(p, cfg, x, sin, cos, is_global=1.0):
    """Full sequence (training, poll, evaluation and prefill): x (..., S, d)
    with weights shared, or x (m, B, S, d) with weights one set per client
    -> (out (..., S, d), (k, v) (..., S, KV, hd)), k rotated as the cache
    holds it."""
    q, k, v = _project_qkv(p, cfg, x, sin, cos)
    o = flash_attention(q, k, v, cfg.sliding_window, is_global)
    kv_shape = (*x.shape[:-1], *k.shape[-2:])
    return linear(o.reshape(*x.shape[:-1], -1), p["wo"]), (k.reshape(kv_shape),
                                                            v.reshape(kv_shape))


def decode_attention(q, k_cache, v_cache, pos: int, window: int = 0,
                     is_global=1.0) -> torch.Tensor:
    """One-token attention: q (B, 1, H, D) against the cache (B, S, KV, D)
    whose entries past ``pos`` are invalid -> (B, 1, H, D) in q's type."""
    b, _, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, kv, h // kv, d).to(torch.float32)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(torch.float32)) / math.sqrt(d)
    kpos = torch.arange(s, device=q.device)
    probs = torch.softmax(scores + _mask_val(pos, kpos, window, is_global), dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, d).to(q.dtype)


def gqa_decode(p, cfg, x, sin_pos, cos_pos, cache, pos: int, is_global=1.0):
    """One token: x (B, 1, d), the one-row RoPE tables of position ``pos``
    and ``cache`` = (k_cache, v_cache) (B, S_max, KV, hd) -> (out (B, 1,
    d), cache), the token's k and v written into the cache at ``pos`` in
    place."""
    k_cache, v_cache = cache
    q, k_new, v_new = _project_qkv(p, cfg, x, sin_pos, cos_pos)
    k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
    o = decode_attention(q, k_cache, v_cache, pos, cfg.sliding_window, is_global)
    return linear(o.reshape(x.shape[0], 1, -1), p["wo"]), (k_cache, v_cache)
