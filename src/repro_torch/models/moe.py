"""Mixture of experts: shared plus routed top-k experts, ported from
``repro.models.moe``.

- ``init_moe`` — the router (fp32, as the reference keeps it), the routed
  experts' ``w_gate``, ``w_up`` (E, d, fe) and ``w_down`` (E, fe, d), and
  the shared experts' ``shared_gate``, ``shared_up`` (d, fs) and
  ``shared_down`` (fs, d), fs = n_shared x fe.  Each leaf is cast to the
  model's type as soon as it is drawn, so that at full width no two fp32
  expert tensors coexist (deepseek-v3's are 15 GB each).
- ``_router`` — fp32 logits and softmax, top-k (equal probabilities
  taken in expert order, as ``jax.lax.top_k`` takes them), the k weights
  renormalised to sum to 1, and the Switch load-balance loss E x sum_e
  f_e p_e, with f_e the share of the (token, slot) assignments that go to
  expert e and p_e the mean router probability of e.
- ``moe_dense`` — every expert runs on every token and the outputs are
  combined with the router weights: exact, no token is dropped.  It is
  what the reference runs whenever it has no device mesh, or
  ``impl="dense"``.  The experts are walked in blocks, as many a
  block as keep its activations within ``_BLOCK_BYTES``, so that the
  (E, T, d) outputs never exist at once
  (deepseek-v3 prefilling 4 x 1280 tokens would need 18.8 GB for them);
  the blocks' combined outputs are summed in fp32 and cast to the
  model's type once, where the reference sums the E products in one
  contraction.
- ``moe_capacity`` — the capacity dispatch over a range of experts, as
  the reference computes it under a device mesh: each expert takes at
  most ``capacity(cfg, t)`` of the (token, slot) assignments of the t
  tokens, the highest-weight first (a stable sort on local expert + (1 -
  weight), in fp32), the rest dropped; the kept rows are gathered into
  (E_loc, cap, d), run through the experts' FFN as batched matrix
  products, weighted by their router weights and added back to their
  tokens.  The reference adds in the model's type, in no fixed order
  (XLA's scatter); the port adds the weighted rows in fp32 (``index_add``,
  atomic and unordered on the card) and casts once, so a bf16 output is
  within one bf16 rounding of the exact sum and an fp32 one within fp32
  rounding of any order.  Gradients flow through the gathered
  activations and the kept router weights, not through the sort.
- ``moe_capacity_sharded`` — the block the reference runs inside
  ``shard_map``: the local experts of the ``mesh_axis`` index, the partial
  outputs summed over that axis (``Mesh.all_reduce_sum``), then the
  shared expert once.
- ``moe_specs`` — the logical axes of each leaf, as the reference names
  them.
- ``route``, ``router_sums``, ``load_balance``, ``scatter_weights``,
  ``dense_sum`` and ``dispatched`` — the router, its load-balance sums
  and loss, and the dense and capacity paths over a given block of
  experts: the pieces that ``transformer._moe_blocks`` composes on a
  rank's storage blocks (the router's sums over the data axes, the
  experts over ``model``).

Weights are shared by the batch, or carry a leading client axis m (one
set per client, as the rest of the model's) in ``moe_dense`` only: the
capacity paths take one model's weights and tokens (T, d), as the
reference's do under a mesh.  In ``moe_dense`` the router statistics, and
so the aux loss, reduce over a group's tokens: the (B, S) tokens of each
client with per-client weights (x (m, B, S, d) -> aux (m,)); with shared
weights, the last two axes before d (x (..., B, S, d) -> aux (...)), as
the reference's per-client ``vmap`` of the loss sees them.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import activation, lecun_init, linear

__all__ = ["init_moe", "moe_specs", "moe_dense", "capacity", "dispatch", "moe_capacity",
           "moe_capacity_sharded", "route", "router_sums", "load_balance", "dense_sum",
           "scatter_weights", "dispatched"]

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


def init_moe(generator: torch.Generator, cfg, dtype: torch.dtype = torch.float32,
             keep=None) -> dict:
    """LeCun-initialised router and experts drawn from ``generator``; the
    router fp32, every other leaf cast to ``dtype`` as soon as it is drawn.
    ``w_down`` has fan-in fe and ``shared_down`` fan-in fs.  ``keep(name,
    leaf)``: what is kept of each leaf, applied as soon as it is drawn and
    cast (a rank's block), before the next is drawn."""
    keep = keep or (lambda name, leaf: leaf)
    shapes = moe_shapes(cfg)
    p = {"router": keep("router", lecun_init(generator, shapes["router"]))}
    for name, shape in shapes.items():
        if name != "router":
            p[name] = keep(name, lecun_init(generator, shape, fan_in=shape[-2]).to(dtype))
    return p


def moe_specs(cfg) -> dict:
    """The logical axes of each leaf of ``init_moe``'s tree."""
    s = {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", "expert_ff"),
        "w_up": ("experts", "embed", "expert_ff"),
        "w_down": ("experts", "expert_ff", "embed"),
    }
    if cfg.moe.n_shared:
        s["shared_gate"] = ("embed", "ffn")
        s["shared_up"] = ("embed", "ffn")
        s["shared_down"] = ("ffn", "embed")
    return s


def route(p, cfg, x2d: torch.Tensor):
    """The router on x2d (..., T, d): top-k (ids (..., T, k) int64, the k
    weights renormalised to sum to 1, fp32 (..., T, k)) and the fp32
    probabilities (..., T, E)."""
    mc = cfg.moe
    logits = linear(x2d.to(torch.float32), p["router"])          # (..., T, E)
    probs = torch.softmax(logits, dim=-1)
    # top-k with equal probabilities in expert order, as jax.lax.top_k
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[..., :mc.top_k], ids[..., :mc.top_k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)      # renormalise over k
    return ids, w, probs


def router_sums(cfg, ids: torch.Tensor, probs: torch.Tensor):
    """The load-balance loss's sums over a group of tokens: each expert's
    count of the (token, slot) assignments (..., E) fp32, no gradient, and
    its probabilities summed over the tokens (..., E)."""
    flat = ids.flatten(-2)
    counts = torch.zeros(*flat.shape[:-1], cfg.moe.n_experts, dtype=torch.float32,
                         device=ids.device)
    counts = counts.scatter_add_(-1, flat, torch.ones_like(flat, dtype=torch.float32))
    return counts, probs.sum(-2)


def load_balance(cfg, counts: torch.Tensor, psum: torch.Tensor, t: int) -> torch.Tensor:
    """The Switch load-balance loss of ``t`` tokens from ``router_sums``'
    sums: E x sum_e f_e p_e, f_e = counts_e / (t x top_k), p_e = psum_e / t."""
    mc = cfg.moe
    return mc.n_experts * torch.sum(counts / (t * mc.top_k) * (psum / t), dim=-1)


def _router(p, cfg, x2d: torch.Tensor):
    """x2d (..., T, d) -> top-k (ids (..., T, k) int64, weights fp32 (...,
    T, k), aux fp32 (...))."""
    ids, w, probs = route(p, cfg, x2d)
    return ids, w, load_balance(cfg, *router_sums(cfg, ids, probs), x2d.shape[-2])


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


def dense_sum(p, cfg, x2d: torch.Tensor, w_full: torch.Tensor) -> torch.Tensor:
    """Every expert of ``p``'s ``w_gate`` / ``w_up`` / ``w_down`` (..., n,
    ...) on every token of x2d (..., T, d), combined with ``w_full`` (...,
    T, n), those experts' router weights in x2d's type: the fp32 sum
    (..., T, d), the experts walked in blocks of at most ``_BLOCK_BYTES``
    of activations."""
    mc = cfg.moe
    e, t, d = p["w_up"].shape[-3], x2d.shape[-2], x2d.shape[-1]
    per_expert = t * (2 * mc.d_expert + d) * x2d.element_size() * max(1, x2d[..., 0, 0].numel())
    expert_block = max(1, min(e, _BLOCK_BYTES // per_expert))
    xe = x2d.unsqueeze(-3)                                           # (..., 1, T, d)
    out = None
    for lo in range(0, e, expert_block):
        n = min(expert_block, e - lo)
        blk = {k: p[k].narrow(-3, lo, n) for k in ("w_gate", "w_up", "w_down")}
        ye = _expert_ffn_all(blk, cfg, xe)                           # (..., n, T, d)
        part = torch.einsum("...te,...etd->...td", w_full.narrow(-1, lo, n), ye)
        out = part.to(torch.float32) if out is None else out + part.to(torch.float32)
    return out


def scatter_weights(cfg, ids: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """Top-k ids and weights (..., T, k) -> every expert's weight (..., T,
    E) in ``dtype``, zero where the token does not go."""
    w_full = torch.zeros(*ids.shape[:-1], cfg.moe.n_experts, dtype=torch.float32,
                         device=ids.device)
    return w_full.scatter(-1, ids, w).to(dtype)


def moe_dense(p, cfg, x: torch.Tensor):
    """All experts on all tokens.  x (..., S, d) -> (out in x's type and
    shape, aux): aux fp32, one per client with per-client weights, else one
    per leading group."""
    x2d = _tokens(p, x)
    ids, w, aux = _router(p, cfg, x2d)
    out = dense_sum(p, cfg, x2d, scatter_weights(cfg, ids, w, x.dtype)).to(x.dtype)
    if cfg.moe.n_shared:
        out = out + _shared_expert(p, cfg, x2d)
    return out.reshape(x.shape), aux


def capacity(cfg, t: int) -> int:
    """The rows each expert takes of ``t`` tokens' assignments: t x top_k x
    capacity_factor / n_experts, rounded half to even (Python's ``round``,
    as the reference computes it), at least 1."""
    mc = cfg.moe
    return int(max(1, round(t * mc.top_k * mc.capacity_factor / mc.n_experts)))


def dispatch(ids: torch.Tensor, w: torch.Tensor, cap: int, expert_offset: int, e_loc: int):
    """The capacity dispatch's slots: router ids and weights (T, k) ->
    (tok_of_slot, w_of_slot, slot_valid), each (e_loc x cap,): slot e x cap
    + j holds the j-th kept assignment of local expert e (token 0 and
    weight 0 where it is empty).  Each expert keeps its ``cap`` assignments
    of highest weight, ties in (token, slot) order: a stable sort on
    local expert + (1 - weight) in fp32, as the reference's."""
    t, k = ids.shape
    dev = ids.device
    flat_ids = ids.reshape(-1)                                   # (T k,)
    flat_w = w.reshape(-1)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    local = flat_ids - expert_offset
    mine = (local >= 0) & (local < e_loc)
    local = torch.where(mine, local, e_loc)                      # sentinel bucket
    # by (local expert, -weight), stable: the lowest weights drop on overflow
    key = (local.to(torch.float32) + (1.0 - flat_w)).detach()
    order = torch.argsort(key, stable=True)
    s_local = local[order]
    s_tok = flat_tok[order]
    s_w = torch.where(mine, flat_w, 0.0)[order]
    npos = s_local.shape[0]
    pos = torch.arange(npos, device=dev)
    first = torch.full((e_loc + 1,), npos, dtype=torch.int64, device=dev).scatter_reduce(
        0, s_local, pos, "amin", include_self=True)
    pos_in_seg = pos - first[s_local]
    valid = (pos_in_seg < cap) & (s_local < e_loc)
    slot = torch.where(valid, s_local * cap + pos_in_seg, e_loc * cap)
    stream_of_slot = torch.full((e_loc * cap + 1,), npos, dtype=torch.int64,
                                device=dev).scatter_reduce(
        0, slot, pos, "amin", include_self=True)[:-1]
    slot_valid = stream_of_slot < npos
    stream_idx = torch.clamp(stream_of_slot, max=npos - 1)
    tok_of_slot = torch.where(slot_valid, s_tok[stream_idx], 0)
    w_of_slot = torch.where(slot_valid, s_w[stream_idx], 0.0)
    return tok_of_slot, w_of_slot, slot_valid


def dispatched(p, cfg, x2d: torch.Tensor, ids: torch.Tensor, w: torch.Tensor, cap: int,
               expert_offset: int = 0, grad_sync=None) -> torch.Tensor:
    """The capacity dispatch of the tokens x2d (T, d), routed to ``ids``
    with weights ``w`` (T, k), over the experts [offset, offset + E_loc)
    that ``p``'s ``w_gate`` / ``w_up`` / ``w_down`` (E_loc, ...) hold, each
    taking ``cap`` rows: the partial output (T, d) in the weights' type,
    which the caller sums over the processes holding the other experts.
    ``grad_sync`` is applied to x2d and ``w`` (``moe_capacity``)."""
    t, d = x2d.shape
    e_loc = p["w_up"].shape[0]
    if grad_sync is not None:
        x2d, w = grad_sync(x2d), grad_sync(w)
    tok_of_slot, w_of_slot, _ = dispatch(ids, w, cap, expert_offset, e_loc)
    xe = x2d.index_select(0, tok_of_slot).reshape(e_loc, cap, d)
    ye = _expert_ffn_all(p, cfg, xe)
    contrib = ye.reshape(-1, d) * w_of_slot[:, None].to(ye.dtype)
    return torch.zeros(t, d, dtype=torch.float32, device=x2d.device).index_add(
        0, tok_of_slot, contrib.to(torch.float32)).to(ye.dtype)


def moe_capacity(p, cfg, x2d: torch.Tensor, expert_offset: int = 0,
                 n_local_experts: int | None = None, include_shared: bool = True,
                 grad_sync=None):
    """Capacity dispatch over the experts [offset, offset + E_loc) of
    ``p``'s ``w_gate`` / ``w_up`` / ``w_down`` (E_loc = ``n_local_experts``,
    ...); the router runs on every expert.  x2d (T, d) -> (the partial output (T, d) in
    x2d's type, which the caller sums over the processes holding the other
    experts; the aux loss fp32, the same on each).

    ``grad_sync`` (for the mesh's callers) is applied to the activations
    and router weights that the dispatch uses, and completes their
    gradients over the processes whose partial outputs are summed
    (``Mesh.grad_sum``); the router's own use of x2d and its aux loss are
    replicated and take no such sum."""
    mc = cfg.moe
    if p["router"].ndim != 2 or x2d.ndim != 2:
        raise ValueError("the capacity dispatch takes one model's weights and tokens (T, d); "
                         "per-client weights run moe_dense")
    ids, w, aux = _router(p, cfg, x2d)
    out = dispatched(p, cfg, x2d, ids, w, capacity(cfg, x2d.shape[0]), expert_offset,
                     grad_sync)
    if include_shared and mc.n_shared:
        out = out + _shared_expert(p, cfg, x2d)
    return out, aux


def moe_capacity_sharded(p, cfg, x: torch.Tensor, mesh, mesh_axis: str = "model"):
    """The reference's ``shard_map`` block: ``p``'s ``w_*`` are this
    process's slice of the experts on ``mesh_axis`` (the router and the
    shared expert whole), x (B_loc, S, d) its tokens.  The routed partial
    outputs are summed over ``mesh_axis``, then the shared expert is added
    once (every process of the axis holds the same tokens).  Returns (out
    (B_loc, S, d), aux)."""
    b, s, d = x.shape
    e_loc = p["w_gate"].shape[0]
    idx = mesh.axis_index(mesh_axis)
    x2d = x.reshape(-1, d)
    out2d, aux = moe_capacity(p, cfg, x2d, expert_offset=idx * e_loc, n_local_experts=e_loc,
                              include_shared=False,
                              grad_sync=lambda t: mesh.grad_sum(t, mesh_axis))
    out2d = mesh.all_reduce_sum(out2d, mesh_axis)
    if cfg.moe.n_shared:
        out2d = out2d + _shared_expert(p, cfg, x2d)
    return out2d.reshape(b, s, d), aux
