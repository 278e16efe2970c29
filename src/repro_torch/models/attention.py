"""Attention, ported from ``repro.models.attention``: GQA with qk-norm,
partial RoPE and the sliding window, and deepseek-v3's MLA, each over the
full sequence and for decode.

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

- ``init_mla`` / ``mla_attention`` / ``mla_decode`` — multi-head latent
  attention: low-rank q and kv projections with a decoupled rotary key
  shared by the heads.  The full sequence materialises per-head keys and
  values from the latent and runs the flash-attention kernel on q and k of
  nope + rope dims, the values zero-padded from ``v_head_dim`` to that
  width (the kernel, as the TPU one, takes one D for q, k and v) and the
  output cut back; the padded columns add nothing to the scores and come
  out zero.  The decode step is the reference's absorbed form: fp32 scores
  against the (latent, k_rope) cache directly, in plain PyTorch.

Sliding-window blending: layer heterogeneity enters through the scalar
``is_global`` flag, as in the reference.

``gqa_attention(..., tp=mesh)`` runs on a rank's blocks of the weights
(``sharding.shard_tree`` under the baseline policy: ``wq``, ``wk``, ``wv``
split by columns and ``wo`` by rows over ``model``, as the reference's
``gqa_specs`` name them all "heads"), tensor-parallel over ``model``,
with one of three rules:

- **whole heads** (the ``wq`` block is ``n_heads / model`` whole heads
  and the ``wk`` / ``wv`` blocks exactly the kv heads those q heads use):
  K3 on the rank's heads, ``wo``'s row block gives a partial output that
  is summed over ``model``; the qk-norm scales, replicated, are used by
  each rank for its own heads, so their gradients are summed over
  ``model``;
- **q on whole heads, kv not** (the kv blocks split a head): ``wk`` and
  ``wv`` are gathered whole for the layer, their gradients summed over
  ``model`` before each rank takes its slice, and each rank projects the
  kv heads its q heads use (one kv head a q head where the groups do not
  fall evenly on the rank), then as above;
- **q not on whole heads**: every projection is gathered whole and the
  layer is computed replicated over ``model`` (each rank's gradient is
  then the whole one, and it keeps its slice).

At 2 x 16 x 16 (model 16): stablelm-3b (32 heads, 32 kv) and gemma3-27b
(32, 16 kv) split on whole heads; glm4-9b's 32 q heads split on whole
heads and its 2 kv heads at 1/8 of a head (the second rule); qwen3-14b's
40 q heads fall at 2.5 heads a rank (the third).  On the test grids
(model 2, the reduced configs' 4 heads) all four split on whole heads;
the tests' micro configs take the other two rules (3 heads; 4 heads
over 1 kv head).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (
    apply_rope,
    column_in,
    gather_whole,
    lecun_init,
    linear,
    per_client,
    rms_norm,
    row_out,
)

__all__ = ["init_gqa", "gqa_shapes", "gqa_specs", "gqa_attention", "gqa_decode", "init_mla",
           "mla_shapes", "mla_specs", "mla_attention", "mla_decode", "naive_attention",
           "flash_attention", "decode_attention", "decode_partial", "decode_attention_split",
           "combine_partials"]

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


def gqa_specs(cfg) -> dict:
    """The logical axes of each leaf of ``init_gqa``'s tree."""
    s = {"wq": ("embed", "heads"), "wk": ("embed", "heads"), "wv": ("embed", "heads"),
         "wo": ("heads", "embed")}
    if cfg.qk_norm:
        s["q_norm"] = (None,)
        s["k_norm"] = (None,)
    return s


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


def _project_qkv(p, cfg, x, sin, cos, heads=None):
    """x (..., S, d) -> q (N, S, H, hd), k and v (N, S, KV, hd), the leading
    axes (client and batch) folded into N; ``heads`` = (H, KV) where the
    weights hold fewer than the config's (a rank's blocks)."""
    s = x.shape[-2]
    h, kv = heads or (cfg.n_heads, cfg.n_kv_heads)
    hd = cfg.resolved_head_dim
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


def gqa_attention(p, cfg, x, sin, cos, is_global=1.0, tp=None, all_kv=False):
    """Full sequence (training, poll, evaluation and prefill): x (..., S, d)
    with weights shared, or x (m, B, S, d) with weights one set per client
    -> (out (..., S, d), (k, v) (..., S, KV, hd)), k rotated as the cache
    holds it.  ``tp``: the mesh whose ``model`` axis splits ``p`` (a rank's
    blocks; x replicated over ``model``); k and v are then the rank's kv
    heads, or with ``all_kv`` (a prefill) the cache block's: the rank's kv
    heads where ``model`` divides them, else every kv head."""
    if tp is not None:
        return _gqa_blocks(p, cfg, x, sin, cos, is_global, tp, all_kv)
    q, k, v = _project_qkv(p, cfg, x, sin, cos)
    o = flash_attention(q, k, v, cfg.sliding_window, is_global)
    kv_shape = (*x.shape[:-1], *k.shape[-2:])
    return linear(o.reshape(*x.shape[:-1], -1), p["wo"]), (k.reshape(kv_shape),
                                                            v.reshape(kv_shape))


def _head_plan(p, cfg, mesh):
    """Which of the module docstring's rules a rank's blocks take: None for
    the third (the layer replicated), else (the rank's q heads ``hl``, its
    first q head, the kv heads [lo, hi) they use, and for each of its q
    heads its kv head's index in [lo, hi) where one kv head a q head must be
    taken, else None)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    m = mesh.shape["model"]
    if p["wq"].shape[1] == h * hd or p["wo"].shape[0] == h * hd or h % m:
        return None
    hl, g = h // m, h // kv
    a = mesh.axis_index("model") * hl
    lo, hi = a // g, (a + hl - 1) // g + 1
    n = hi - lo
    idx = [(a + i) // g - lo for i in range(hl)]
    if not hl % n and idx == [i // (hl // n) for i in range(hl)]:
        idx = None
    return hl, a, lo, hi, idx


def _whole(p, cfg, mesh):
    """``p`` with every projection that ``model`` splits gathered whole."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    whole = dict(p)
    for k, n in (("wq", h), ("wk", kv), ("wv", kv), ("wo", h)):
        dim = 0 if k == "wo" else 1
        if p[k].shape[dim] != n * hd:
            whole[k] = gather_whole(p[k], mesh, dim)
    return whole


def _kv_weights(p, cfg, mesh, lo, hi, every):
    """The rank's q-head plan's kv projections: its ``wk`` / ``wv`` blocks
    where they are the kv heads [lo, hi), else the leaves gathered whole
    (their gradients summed over ``model``, each rank using them for its own
    heads) and cut to [lo, hi), or kept whole with ``every``; and the
    qk-norm scales, their gradients summed over ``model``."""
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    pl = {}
    for k in ("wk", "wv"):
        split = p[k].shape[1] != kv * hd
        if split and kv % mesh.shape["model"] == 0:   # the block is [lo, hi)
            pl[k] = p[k]
        else:
            w = gather_whole(p[k], mesh, 1, partial=True) if split else \
                mesh.grad_sum(p[k], "model")
            pl[k] = w if every else w[:, lo * hd:hi * hd]
    for k in ("q_norm", "k_norm"):
        if k in p:
            pl[k] = mesh.grad_sum(p[k], "model")
    return pl


def _gqa_blocks(p, cfg, x, sin, cos, is_global, mesh, all_kv=False):
    """``gqa_attention`` on a rank's blocks, by the rules of the module's
    docstring."""
    plan = _head_plan(p, cfg, mesh)
    if plan is None:
        return gqa_attention(_whole(p, cfg, mesh), cfg, x, sin, cos, is_global)
    hl, _, lo, hi, idx = plan
    x = column_in(x, mesh)
    pl = {"wq": p["wq"], **_kv_weights(p, cfg, mesh, lo, hi, all_kv)}
    every = all_kv and pl["wk"].shape[1] != (hi - lo) * cfg.resolved_head_dim
    q, k, v = _project_qkv(pl, cfg, x, sin, cos,
                           heads=(hl, cfg.n_kv_heads if every else hi - lo))
    kv_shape = (*x.shape[:-1], *k.shape[-2:])
    cache = (k.reshape(kv_shape), v.reshape(kv_shape))
    if every:
        k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    if idx is not None:
        k, v = k[:, :, idx], v[:, :, idx]        # one kv head a q head
    o = flash_attention(q, k, v, cfg.sliding_window, is_global)
    out = row_out(linear(o.reshape(*x.shape[:-1], -1), p["wo"]), mesh)
    if not all_kv:
        kv_shape = (*x.shape[:-1], *k.shape[-2:])
        cache = (k.reshape(kv_shape), v.reshape(kv_shape))
    return out, cache


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


def decode_partial(q, k_block, v_block, pos: int, first: int = 0, window: int = 0,
                   is_global=1.0):
    """``decode_attention`` over one block of the cache, the positions
    [first, first + S) of k_block and v_block (B, S, KV, D), masked on
    those global positions -> the block's partial softmax in fp32: its
    score maximum m (B, KV, G, 1), l = sum exp(s - m) (B, KV, G, 1) and o
    = sum exp(s - m) v (B, KV, G, D), G = H / KV.  A block with no valid
    position gives l = o = 0."""
    b, _, h, d = q.shape
    s, kv = k_block.shape[1], k_block.shape[2]
    qg = q.reshape(b, kv, h // kv, d).to(torch.float32)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_block.to(torch.float32)) / math.sqrt(d)
    kpos = torch.arange(first, first + s, device=q.device)
    scores = scores + _mask_val(pos, kpos, window, is_global)
    m = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - m)
    valid = m > _NEG / 2           # a masked score is _NEG: the block's max then too
    l = torch.where(valid, e.sum(-1, keepdim=True), 0.0)
    o = torch.where(valid, torch.einsum("bkgs,bskd->bkgd", e, v_block.to(torch.float32)), 0.0)
    return m, l, o


def combine_partials(m, l, o, mesh) -> torch.Tensor:
    """Partial softmaxes of blocks of a sequence split over the data axes
    of ``mesh`` (every axis but ``model``), this rank's the score maximum
    m (..., 1), l = sum exp(s - m) (..., 1) and o = sum exp(s - m) v (...,
    D), fp32: each rescaled to the maximum over the ranks, M = max_r m_r,
    and summed over them, l = sum_r l_r exp(m_r - M) and o = sum_r o_r
    exp(m_r - M) (one all-reduce of o and l together) -> o / l (..., D).  A
    block with no valid position (l = o = 0) adds exactly 0."""
    axes = tuple(a for a in mesh.axis_names if a != "model")
    d = o.shape[-1]
    top = mesh.all_reduce_max(m.clone(), axes)
    scale = torch.exp(m - top)
    ol = mesh.all_reduce_sum(torch.cat([o * scale, l * scale], dim=-1), axes)
    return ol[..., :d] / ol[..., d:]


def decode_attention_split(q, k_block, v_block, pos: int, first: int, mesh, window: int = 0,
                           is_global=1.0) -> torch.Tensor:
    """``decode_attention`` over a cache whose sequence lies in blocks on
    the data axes of ``mesh`` (every axis but ``model``), this rank's the
    positions [first, first + S): each rank's partial (``decode_partial``)
    combined over them (``combine_partials``) -> (B, 1, H, D) in q's type.
    A block with no valid position adds exactly 0; the block holding
    ``pos`` always has one."""
    b, _, h, d = q.shape
    out = combine_partials(*decode_partial(q, k_block, v_block, pos, first, window, is_global),
                           mesh)
    return out.reshape(b, 1, h, d).to(q.dtype)


def gqa_decode(p, cfg, x, sin_pos, cos_pos, cache, pos: int, is_global=1.0, tp=None,
               seq=None):
    """One token: x (B, 1, d), the one-row RoPE tables of position ``pos``
    and ``cache`` = (k_cache, v_cache) (B, S_max, KV, hd) -> (out (B, 1,
    d), cache), the token's k and v written into the cache at ``pos`` in
    place.  ``tp``: on a rank's blocks, by ``gqa_attention``'s rules, the
    cache being the rank's block: its kv heads where ``model`` divides them
    (the first rule), else every kv head, each of which the rank projects
    and writes, attending its q heads to the kv heads they use.  ``seq``
    (with ``tp``): the cache block holds the positions [seq, seq + S) of a
    sequence split over ``tp``'s data axes; the token is written where
    ``pos`` falls in the block, and the attention is
    ``decode_attention_split``'s."""
    k_cache, v_cache = cache
    plan = None if tp is None else _head_plan(p, cfg, tp)
    if tp is not None and plan is None:
        p = _whole(p, cfg, tp)
    if plan is None:
        q, k_new, v_new = _project_qkv(p, cfg, x, sin_pos, cos_pos)
    else:
        hl, _, lo, hi, idx = plan
        pl = {"wq": p["wq"], **_kv_weights(p, cfg, tp, lo, hi, every=True)}
        q, k_new, v_new = _project_qkv(pl, cfg, x, sin_pos, cos_pos,
                                       heads=(hl, k_cache.shape[2]))
    if seq is None or seq <= pos < seq + k_cache.shape[1]:
        k_cache[:, pos - (seq or 0)] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, pos - (seq or 0)] = v_new[:, 0].to(v_cache.dtype)
    kc, vc = k_cache, v_cache
    if plan is not None:
        if kc.shape[2] != hi - lo:
            kc, vc = kc[:, :, lo:hi], vc[:, :, lo:hi]
        if idx is not None:
            kc, vc = kc[:, :, idx], vc[:, :, idx]
    if seq is None:
        o = decode_attention(q, kc, vc, pos, cfg.sliding_window, is_global)
    else:
        o = decode_attention_split(q, kc, vc, pos, seq, tp, cfg.sliding_window, is_global)
    out = linear(o.reshape(x.shape[0], 1, -1), p["wo"])
    return (out if plan is None else row_out(out, tp)), (k_cache, v_cache)


# ---------------------------------------------------------------------------
# MLA (deepseek-v3)
# ---------------------------------------------------------------------------


def mla_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Parameter shapes of one MLA block, in the reference's order."""
    d, h = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {"wq_a": (d, rq), "q_norm": (rq,), "wq_b": (rq, h * (nope + rope)),
            "wkv_a": (d, rkv + rope), "kv_norm": (rkv,), "wkv_b": (rkv, h * (nope + vd)),
            "wo": (h * vd, d)}


def mla_specs(cfg) -> dict:
    """The logical axes of each leaf of ``init_mla``'s tree."""
    return {"wq_a": ("embed", "q_lora"), "q_norm": (None,), "wq_b": ("q_lora", "heads"),
            "wkv_a": ("embed", None), "kv_norm": (None,), "wkv_b": ("kv_lora", "heads"),
            "wo": ("heads", "embed")}


def init_mla(generator: torch.Generator, cfg) -> dict[str, torch.Tensor]:
    """LeCun-initialised projections (``wo`` with fan-in H * v_head_dim),
    zero norm scales; fp32, drawn from ``generator``."""
    p = {}
    for name, shape in mla_shapes(cfg).items():
        if len(shape) == 1:
            p[name] = torch.zeros(shape, device=generator.device)
        else:
            p[name] = lecun_init(generator, shape, fan_in=shape[0])
    return p


def _mla_heads(p, cfg, mesh):
    """The rank's q heads where ``model`` splits the MLA projections on
    whole heads (``wq_b`` / ``wkv_b`` by columns, ``wo`` by rows), else
    None: the leaves are whole, or gathered whole (their split falls mid-
    head) and the layer computed replicated over ``model``."""
    h = cfg.n_heads
    if mesh is None or p["wq_b"].shape[1] == h * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) \
            or h % mesh.shape["model"]:
        return None
    return h // mesh.shape["model"]


def _mla_whole(p, cfg, mesh):
    """``p`` with every projection that ``model`` splits gathered whole."""
    h, nope, rope, vd = (cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim)
    whole = dict(p)
    for k, n, dim in (("wq_b", h * (nope + rope), 1), ("wkv_b", h * (nope + vd), 1),
                      ("wo", h * vd, 0)):
        if p[k].shape[dim] != n:
            whole[k] = gather_whole(p[k], mesh, dim)
    return whole


def _mla_qkv_latent(p, cfg, x, sin, cos, heads=None, tp=None):
    """The shared front: x (..., S, d) -> q_nope (N, S, H, nope), rotated
    q_rope (N, S, H, rope), the normed latent (..., S, kv_lora_rank) and
    the rotated shared k_rope (..., S, rope); N folds the leading axes.
    ``heads``: the q heads ``wq_b`` holds (a rank's, ``tp``); the normed
    q latent then feeds them through ``column_in``, so that the replicated
    ``wq_a`` and ``q_norm`` take their whole gradient on every rank."""
    s = x.shape[-2]
    h, nope, rope = heads or cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    qa = linear(x, p["wq_a"])
    qa = rms_norm(qa, per_client(p["q_norm"], qa), cfg.norm_eps)
    q = linear(qa if tp is None else column_in(qa, tp), p["wq_b"])
    q = q.reshape(-1, s, h, nope + rope)
    q_nope, q_rope = q[..., :nope], apply_rope(q[..., nope:], sin, cos)
    kv_a = linear(x, p["wkv_a"])
    lat = kv_a[..., : cfg.kv_lora_rank]
    latent = rms_norm(lat, per_client(p["kv_norm"], lat), cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., cfg.kv_lora_rank:].unsqueeze(-2), sin, cos).squeeze(-2)
    return q_nope, q_rope, latent, k_rope


def mla_attention(p, cfg, x, sin, cos, is_global=1.0, tp=None):
    """Full sequence (training and prefill): x (..., S, d) -> (out (..., S,
    d), (latent (..., S, kv_lora_rank), k_rope (..., S, rope))), the
    compressed decode cache.  ``tp``: on a rank's blocks (x replicated
    over ``model``): K3 on the rank's heads where ``model`` splits the
    projections on whole heads, the latent and k_rope feeding them through
    ``column_in``, ``wo``'s row block's partial output summed over
    ``model``; else every projection gathered whole and the layer computed
    replicated."""
    hl = _mla_heads(p, cfg, tp)
    if tp is not None and hl is None:
        return mla_attention(_mla_whole(p, cfg, tp), cfg, x, sin, cos, is_global)
    s = x.shape[-2]
    h = hl or cfg.n_heads
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    if vd > nope + rope:
        raise ValueError(f"v_head_dim {vd} exceeds the q/k head width {nope + rope}")
    q_nope, q_rope, latent, k_rope = _mla_qkv_latent(p, cfg, x, sin, cos, hl, tp)
    lat, kr = (latent, k_rope) if tp is None else (column_in(latent, tp), column_in(k_rope, tp))
    kvb = linear(lat, p["wkv_b"]).reshape(-1, s, h, nope + vd)
    k_nope, v = kvb[..., :nope], kvb[..., nope:]
    n = k_nope.shape[0]
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, kr.reshape(n, s, 1, rope).expand(n, s, h, rope)], dim=-1)
    v_full = F.pad(v, (0, nope + rope - vd))
    o = flash_attention(q_full, k_full, v_full, cfg.sliding_window, is_global)[..., :vd]
    out = linear(o.reshape(*x.shape[:-1], h * vd), p["wo"])
    return (out if tp is None else row_out(out, tp)), (latent, k_rope)


def mla_decode(p, cfg, x, sin_pos, cos_pos, cache, pos: int, is_global=1.0, tp=None,
               seq=None):
    """Absorbed-matmul decode of one token: x (B, 1, d) and ``cache`` =
    (latent (B, S_max, kv_lora_rank), k_rope (B, S_max, rope)) -> (out
    (B, 1, d), cache), the token's latent and k_rope written into the cache
    at ``pos`` in place.  The scores are taken against the latent cache
    with ``wkv_b``'s key half absorbed into q, in fp32.  ``tp``: on a
    rank's blocks, ``mla_attention``'s rules (the rank's heads, ``wo``'s
    partial output summed over ``model``); ``seq`` (with ``tp``): the cache
    block holds the positions [seq, seq + S) of a sequence split over
    ``tp``'s data axes, the token is written where ``pos`` falls in it, and
    each rank's partial softmax and weighted latent context are combined
    over the data axes (``combine_partials``) before ``wkv_b``'s value
    half."""
    hl = _mla_heads(p, cfg, tp)
    if tp is not None and hl is None:
        p = _mla_whole(p, cfg, tp)
    b = x.shape[0]
    h = hl or cfg.n_heads
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    rkv = cfg.kv_lora_rank
    latent_c, krope_c = cache
    q_nope, q_rope, latent_new, krope_new = _mla_qkv_latent(p, cfg, x, sin_pos, cos_pos, hl)
    first = seq or 0
    if seq is None or seq <= pos < seq + latent_c.shape[1]:
        latent_c[:, pos - first] = latent_new[:, 0].to(latent_c.dtype)
        krope_c[:, pos - first] = krope_new[:, 0].to(krope_c.dtype)
    f32 = torch.float32
    wkv_b = p["wkv_b"].reshape(rkv, h, nope + vd).to(f32)
    wk, wv = wkv_b[..., :nope], wkv_b[..., nope:]
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].to(f32), wk)
    lat = latent_c.to(f32)
    s_lat = torch.einsum("bhr,bsr->bhs", q_lat, lat)
    s_rope = torch.einsum("bhr,bsr->bhs", q_rope[:, 0].to(f32), krope_c.to(f32))
    scores = (s_lat + s_rope) / math.sqrt(nope + rope)
    kpos = torch.arange(first, first + latent_c.shape[1], device=x.device)
    scores = scores + _mask_val(pos, kpos, cfg.sliding_window, is_global)
    if seq is None:
        ctx = torch.einsum("bhs,bsr->bhr", torch.softmax(scores, dim=-1), lat)
    else:
        m = scores.amax(-1, keepdim=True)
        e = torch.exp(scores - m)
        valid = m > _NEG / 2       # a block with no valid position adds nothing
        l = torch.where(valid, e.sum(-1, keepdim=True), 0.0)
        ctx = combine_partials(m, l, torch.where(valid, torch.einsum("bhs,bsr->bhr", e, lat),
                                                 0.0), tp)
    o = torch.einsum("bhr,rhv->bhv", ctx, wv)
    out = linear(o.reshape(b, 1, h * vd).to(x.dtype), p["wo"])
    return (out if hl is None else row_out(out, tp)), (latent_c, krope_c)
