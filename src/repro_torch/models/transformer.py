"""Decoder stack, ported from ``repro.models.transformer`` over token
inputs, with two block types: ``attn`` (pre-norm GQA attention plus
pre-norm dense MLP) and ``hymba`` (attention in parallel with Mamba heads on
the same normed input, their outputs fused as the mean of per-branch
RMS-normed outputs, then the MLP).

Parameters live in one flat fp32 vector (P,), and a cohort of m client
models is one (m, P) tensor, as for the MLP.  ``TransformerLayout`` gives
the reference's parameter tree as views of either: ``{"layers": [{
"norm1_scale", ..., "attn": {wq, wk, wv, wo}, "mlp": {w_up, w_down}}, ...],
"final_norm_*", "embed", "head"}`` (a hymba layer adds ``"ssm": {...}``,
``attn_out_norm`` and ``ssm_out_norm``), each leaf with the reference's shape
behind the leading client axis, if any.  The views come from one
``torch.split``, so the gradient of the flat vector is assembled by one
concatenation rather than one full-size scatter per leaf.

``forward`` takes tokens (..., S) with weights (P,) shared by the whole
batch (poll, evaluation), or tokens (m, B, S) with weights (m, P), one set
per client (local SGD).  Client and batch axes fold into one batch axis for
attention, which runs through the flash-attention kernel on the card, and
into the rows of the selective-scan kernel for the Mamba heads.
The reference's ``remat`` (``jax.checkpoint`` per layer) changes no
number and is not mapped.  What the port does not run yet is rejected up
front: the ``xlstm`` block, MoE, MLA, non-token inputs and the MTP head.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models.attention import gqa_attention, gqa_shapes, init_gqa
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    activation,
    layer_norm,
    lecun_init,
    linear,
    per_client,
    rms_norm,
    rope_table,
)

__all__ = [
    "TransformerLayout", "check_supported", "layer_flags", "init_transformer",
    "embed_inputs", "forward", "output_head",
]


def check_supported(cfg) -> None:
    """Raise for what the port does not run yet."""
    unsupported = [
        (cfg.block_type not in ("attn", "hymba"),
         f"block_type={cfg.block_type!r} (xlstm comes in a later slice)"),
        (cfg.block_type == "hymba" and (cfg.ssm is None or cfg.ssm.family != "mamba"),
         "a hymba block without a mamba SSM config"),
        (cfg.moe is not None, "MoE layers"),
        (cfg.use_mla, "MLA attention"),
        (cfg.input_mode != "tokens", f"input_mode={cfg.input_mode!r}"),
        (cfg.mtp, "the MTP head"),
        (cfg.dtype != "float32", f"dtype={cfg.dtype!r} (the port trains in float32)"),
    ]
    for bad, what in unsupported:
        if bad:
            raise ValueError(f"repro_torch's transformer does not implement {what} yet "
                             f"(model {cfg.name!r}); the JAX package repro runs it")


# ---------------------------------------------------------------------------
# Flags / layout
# ---------------------------------------------------------------------------


def layer_flags(cfg) -> dict[str, np.ndarray]:
    pat = (cfg.layer_pattern * cfg.n_layers)[: cfg.n_layers]
    if len(cfg.layer_pattern) == cfg.n_layers:
        pat = cfg.layer_pattern
    is_global = np.array([1.0 if c in "G" else 0.0 for c in pat], np.float32)
    is_mlstm = np.array([1.0 if c == "M" else 0.0 for c in pat], np.float32)
    return {"is_global": is_global, "is_mlstm": is_mlstm}


def _norm_shapes(cfg, name) -> dict[str, tuple[int, ...]]:
    if cfg.norm == "layernorm":
        return {name + "_scale": (cfg.d_model,), name + "_bias": (cfg.d_model,)}
    return {name: (cfg.d_model,)}


def _mlp_shapes(cfg) -> dict[str, tuple[int, ...]]:
    d, f = cfg.d_model, cfg.d_ff
    shapes = {"w_up": (d, f), "w_down": (f, d)}
    if cfg.mlp_activation in ("swiglu", "geglu"):
        shapes["w_gate"] = (d, f)
    return shapes


class TransformerLayout:
    """Where each parameter of the reference's tree sits in the flat
    vector: layer by layer (norm1, attn, for hymba ssm, attn_out_norm and
    ssm_out_norm, then norm2, mlp), then the final norm, the embedding and
    the untied head."""

    def __init__(self, cfg):
        check_supported(cfg)
        self.cfg = cfg
        self.entries: list[tuple[tuple[str, ...], tuple[int, ...]]] = []
        for i in range(cfg.n_layers):
            for name, shape in _norm_shapes(cfg, "norm1").items():
                self.entries.append((("layers", i, name), shape))
            for name, shape in gqa_shapes(cfg).items():
                self.entries.append((("layers", i, "attn", name), shape))
            if cfg.block_type == "hymba":
                for name, shape in ssm_mod.mamba_shapes(cfg).items():
                    self.entries.append((("layers", i, "ssm", name), shape))
                for name in ("attn_out_norm", "ssm_out_norm"):
                    self.entries.append((("layers", i, name), (cfg.d_model,)))
            for name, shape in _norm_shapes(cfg, "norm2").items():
                self.entries.append((("layers", i, name), shape))
            for name, shape in _mlp_shapes(cfg).items():
                self.entries.append((("layers", i, "mlp", name), shape))
        for name, shape in _norm_shapes(cfg, "final_norm").items():
            self.entries.append(((name,), shape))
        self.entries.append((("embed",), (cfg.vocab, cfg.d_model)))
        if not cfg.tie_embeddings:
            self.entries.append((("head",), (cfg.d_model, cfg.vocab)))
        self.sizes = [math.prod(shape) for _, shape in self.entries]
        self.n_params = sum(self.sizes)

    def views(self, flat: torch.Tensor) -> dict:
        """The parameter tree as views of a (..., P) tensor; every leaf has
        the reference's shape behind the leading axes of ``flat``."""
        if flat.shape[-1] != self.n_params:
            raise ValueError(f"parameter vector has {flat.shape[-1]} entries; "
                             f"{self.cfg.name} needs {self.n_params}")
        tree: dict = {"layers": [{} for _ in range(self.cfg.n_layers)]}
        for (path, shape), part in zip(self.entries, torch.split(flat, self.sizes, dim=-1)):
            node = tree
            for key in path[:-1]:
                node = node[key] if isinstance(key, int) else node.setdefault(key, {})
            node[path[-1]] = part.unflatten(-1, shape)
        return tree

    def flatten(self, tree: dict) -> torch.Tensor:
        """The inverse of ``views`` for an unbatched tree: (P,) fp32."""
        parts = []
        for path, shape in self.entries:
            node = tree
            for key in path:
                node = node[key]
            if tuple(node.shape) != shape:
                raise ValueError(f"{'/'.join(map(str, path))} has shape {tuple(node.shape)}, "
                                 f"expected {shape}")
            parts.append(node.reshape(-1).to(torch.float32))
        return torch.cat(parts)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_norm(cfg, name, device) -> dict:
    if cfg.norm == "layernorm":
        return {name + "_scale": torch.ones(cfg.d_model, device=device),
                name + "_bias": torch.zeros(cfg.d_model, device=device)}
    return {name: torch.zeros(cfg.d_model, device=device)}


def _init_mlp(generator, cfg) -> dict:
    shapes = _mlp_shapes(cfg)
    p = {"w_up": lecun_init(generator, shapes["w_up"]),
         "w_down": lecun_init(generator, shapes["w_down"], fan_in=cfg.d_ff)}
    if "w_gate" in shapes:
        p["w_gate"] = lecun_init(generator, shapes["w_gate"])
    return p


def init_transformer(generator: torch.Generator, cfg) -> torch.Tensor:
    """Flat (P,) fp32 initial parameters drawn from ``generator`` on its
    device, with the reference's distributions: LeCun projections, unit
    LayerNorm scales (zero RMSNorm scales), zero biases, N(0, 0.02^2)
    embedding, LeCun head; a hymba layer's Mamba heads as ``init_mamba``
    draws them and zero scales for its two output norms."""
    layout = TransformerLayout(cfg)
    dev = generator.device
    layers = []
    for _ in range(cfg.n_layers):
        layer = {**_init_norm(cfg, "norm1", dev), **_init_norm(cfg, "norm2", dev)}
        layer["attn"] = init_gqa(generator, cfg)
        if cfg.block_type == "hymba":
            layer["ssm"] = ssm_mod.init_mamba(generator, cfg)
            layer["attn_out_norm"] = torch.zeros(cfg.d_model, device=dev)
            layer["ssm_out_norm"] = torch.zeros(cfg.d_model, device=dev)
        layer["mlp"] = _init_mlp(generator, cfg)
        layers.append(layer)
    tree = {"layers": layers, **_init_norm(cfg, "final_norm", dev)}
    tree["embed"] = torch.randn((cfg.vocab, cfg.d_model), generator=generator, device=dev) * 0.02
    if not cfg.tie_embeddings:
        tree["head"] = lecun_init(generator, (cfg.d_model, cfg.vocab))
    return layout.flatten(tree)


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _norm(p, cfg, x, name):
    if cfg.norm == "layernorm":
        return layer_norm(x, per_client(p[name + "_scale"], x), per_client(p[name + "_bias"], x),
                          cfg.norm_eps)
    return rms_norm(x, per_client(p[name], x), cfg.norm_eps)


def _mlp(p, cfg, x):
    gate = linear(x, p["w_gate"]) if "w_gate" in p else None
    h = activation(cfg.mlp_activation, linear(x, p["w_up"]), gate)
    return linear(h, p["w_down"])


def embed_inputs(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids (..., S) -> (..., S, d); with per-client tables (m, V, d)
    the tokens are (m, B, S) and client i reads its own table."""
    table = params["embed"]
    if table.ndim == 2:
        x = table[tokens.long()]
    else:
        rows = torch.arange(table.shape[0], device=tokens.device)
        x = table[rows.view(-1, *([1] * (tokens.ndim - 1))), tokens.long()]
    if cfg.tie_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def _rope_tables(cfg, seq_len, device):
    """Two (S, rot / 2) table pairs (local theta, global theta)."""
    dim = int(cfg.resolved_head_dim * cfg.rope_fraction)
    dim -= dim % 2
    if dim == 0:
        dim = 2
    tabs_l = rope_table(seq_len, dim, cfg.rope_theta, device)
    tabs_g = rope_table(seq_len, dim, cfg.rope_theta_global, device) if cfg.rope_theta_global \
        else tabs_l
    return tabs_l, tabs_g


def _select_rope(tabs_l, tabs_g, is_global: float):
    return tabs_g if is_global > 0 else tabs_l


def _apply_layer_seq(pl, cfg, x, is_global: float, tabs_l, tabs_g):
    """One layer over the full sequence: attention (in parallel with the
    Mamba heads for hymba), then the MLP."""
    sin, cos = _select_rope(tabs_l, tabs_g, is_global)
    h = _norm(pl, cfg, x, "norm1")
    a_out = gqa_attention(pl["attn"], cfg, h, sin, cos, is_global)
    if cfg.block_type == "hymba":
        s_out = ssm_mod.mamba_seq(pl["ssm"], cfg, h)
        a_out = 0.5 * (rms_norm(a_out, per_client(pl["attn_out_norm"], a_out), cfg.norm_eps)
                       + rms_norm(s_out, per_client(pl["ssm_out_norm"], s_out), cfg.norm_eps))
    x = x + a_out
    h2 = _norm(pl, cfg, x, "norm2")
    return x + _mlp(pl["mlp"], cfg, h2)


def forward(params, cfg, tokens: torch.Tensor, layout: TransformerLayout | None = None):
    """Hidden states after the final norm, (..., S, d).  ``params`` is the
    flat (P,) or (m, P) vector (cut by ``layout``) or its tree of views."""
    if isinstance(params, torch.Tensor):
        params = (layout or TransformerLayout(cfg)).views(params)
    x = embed_inputs(params, cfg, tokens)
    tabs_l, tabs_g = _rope_tables(cfg, x.shape[-2], x.device)
    for pl, is_global in zip(params["layers"], layer_flags(cfg)["is_global"]):
        x = _apply_layer_seq(pl, cfg, x, float(is_global), tabs_l, tabs_g)
    return _norm(params, cfg, x, "final_norm")


def output_head(params, cfg) -> torch.Tensor:
    """The (d, V) output projection, (m, d, V) per client: the tied
    embedding's transpose or the separate head."""
    return params["embed"].transpose(-1, -2) if cfg.tie_embeddings else params["head"]
