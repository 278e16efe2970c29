"""Mixture of experts: shared plus routed top-k experts, ported from
``repro.models.moe`` (its dense path).

- ``init_moe`` — the router (fp32, as the reference keeps it), the routed
  experts' ``w_gate``, ``w_up`` (E, d, fe) and ``w_down`` (E, fe, d), and
  the shared experts' ``shared_gate``, ``shared_up`` (d, fs) and
  ``shared_down`` (fs, d), fs = n_shared x fe.  Each leaf is cast to the
  model's type as soon as it is drawn, so that at full width no two fp32
  expert tensors coexist (deepseek-v3's are 15 GB each).
- ``_router`` — fp32 logits and softmax, top-k, the k weights
  renormalised to sum to 1, and the Switch load-balance loss E x sum_e
  f_e p_e, with f_e the share of the (token, slot) assignments that go to
  expert e and p_e the mean router probability of e.
- ``moe_dense`` — every expert runs on every token and the outputs are
  combined with the router weights: exact, no token is dropped.  It is
  what the reference runs whenever it has no device mesh, which the
  one-card port never has.  The experts are walked in blocks, as many a
  block as keep its activations within ``_BLOCK_BYTES``, so that the
  (E, T, d) outputs never exist at once
  (deepseek-v3 prefilling 4 x 1280 tokens would need 18.8 GB for them);
  the blocks' combined outputs are summed in fp32 and cast to the
  model's type once, where the reference sums the E products in one
  contraction.

Weights are shared by the batch, or carry a leading client axis m (one
set per client), as the rest of the model's.  The router statistics, and
so the aux loss, reduce over a group's tokens: the (B, S) tokens of each
client with per-client weights (x (m, B, S, d) -> aux (m,)); with shared
weights, the last two axes before d (x (..., B, S, d) -> aux (...)), as
the reference's per-client ``vmap`` of the loss sees them.

The capacity dispatch (``moe_capacity``, ``moe_capacity_sharded``) runs in
the reference only under a device mesh, and is not ported.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import activation, lecun_init, linear

__all__ = ["init_moe", "moe_dense"]

# the bytes a block of experts may take for its (T, fe) activations and
# (T, d) outputs in ``moe_dense``
_BLOCK_BYTES = 1 << 30


def moe_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Parameter shapes of one MoE block, in ``init_moe``'s order."""
    d, mc = cfg.d_model, cfg.moe
    e, fe = mc.n_experts, mc.d_expert
    shapes = {"router": (d, e), "w_gate": (e, d, fe), "w_up": (e, d, fe), "w_down": (e, fe, d)}
    if mc.n_shared:
        fs = fe * mc.n_shared
        shapes |= {"shared_gate": (d, fs), "shared_up": (d, fs), "shared_down": (fs, d)}
    return shapes


def init_moe(generator: torch.Generator, cfg, dtype: torch.dtype = torch.float32) -> dict:
    """LeCun-initialised router and experts drawn from ``generator``; the
    router fp32, every other leaf cast to ``dtype`` as soon as it is drawn.
    ``w_down`` has fan-in fe and ``shared_down`` fan-in fs."""
    shapes = moe_shapes(cfg)
    p = {"router": lecun_init(generator, shapes["router"])}
    for name, shape in shapes.items():
        if name != "router":
            p[name] = lecun_init(generator, shape, fan_in=shape[-2]).to(dtype)
    return p


def _router(p, cfg, x2d: torch.Tensor):
    """x2d (..., T, d) -> top-k (ids (..., T, k) int64, weights fp32 (...,
    T, k), aux fp32 (...))."""
    mc = cfg.moe
    logits = linear(x2d.to(torch.float32), p["router"])          # (..., T, E)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, mc.top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)      # renormalise over k
    e, t = mc.n_experts, x2d.shape[-2]
    flat = ids.flatten(-2)
    counts = torch.zeros(*flat.shape[:-1], e, dtype=torch.float32, device=x2d.device)
    f = counts.scatter_add_(-1, flat, torch.ones_like(flat, dtype=torch.float32)) / (
        t * mc.top_k)
    aux = e * torch.sum(f * probs.mean(-2), dim=-1)
    return ids, w, aux


def _shared_expert(p, cfg, x2d):
    h = activation(cfg.mlp_activation, linear(x2d, p["shared_up"]),
                   linear(x2d, p["shared_gate"]))
    return linear(h, p["shared_down"])


def _expert_ffn_all(p, cfg, xe):
    """Batched per-expert FFN: xe (..., E, C, d) (broadcast over E where
    every expert sees the same tokens) with weights (..., E, d, fe) ->
    (..., E, C, d)."""
    h = activation(cfg.mlp_activation, xe @ p["w_up"], xe @ p["w_gate"])
    return h @ p["w_down"]


def _tokens(p, x: torch.Tensor) -> torch.Tensor:
    """x as (..., T, d) over the groups the router statistics reduce over."""
    d = x.shape[-1]
    if p["router"].ndim == 3:
        return x.reshape(x.shape[0], -1, d)
    return x.reshape(*x.shape[:-3], -1, d) if x.ndim >= 3 else x


def moe_dense(p, cfg, x: torch.Tensor):
    """All experts on all tokens.  x (..., S, d) -> (out in x's type and
    shape, aux): aux fp32, one per client with per-client weights, else one
    per leading group."""
    mc = cfg.moe
    x2d = _tokens(p, x)
    ids, w, aux = _router(p, cfg, x2d)
    e, t, d = mc.n_experts, x2d.shape[-2], x2d.shape[-1]
    w_full = torch.zeros(*ids.shape[:-1], e, dtype=torch.float32, device=x.device)
    w_full = w_full.scatter(-1, ids, w).to(x.dtype)                 # (..., T, E)
    per_expert = t * (2 * mc.d_expert + d) * x.element_size() * max(1, x2d[..., 0, 0].numel())
    expert_block = max(1, min(e, _BLOCK_BYTES // per_expert))
    xe = x2d.unsqueeze(-3)                                           # (..., 1, T, d)
    out = None
    for lo in range(0, e, expert_block):
        n = min(expert_block, e - lo)
        blk = {k: p[k].narrow(-3, lo, n) for k in ("w_gate", "w_up", "w_down")}
        ye = _expert_ffn_all(blk, cfg, xe)                           # (..., n, T, d)
        part = torch.einsum("...te,...etd->...td", w_full.narrow(-1, lo, n), ye)
        out = part.to(torch.float32) if out is None else out + part.to(torch.float32)
    out = out.to(x.dtype)
    if mc.n_shared:
        out = out + _shared_expert(p, cfg, x2d)
    return out.reshape(x.shape), aux
