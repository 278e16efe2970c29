"""Decoder stack, ported from ``repro.models.transformer``, with three
block types: ``attn`` (pre-norm GQA or MLA attention
plus a pre-norm dense or MoE MLP), ``hymba`` (attention in parallel with
Mamba heads on the same normed input, their outputs fused as the mean of
per-branch RMS-normed outputs, then the MLP) and ``xlstm`` (a pre-norm
mLSTM or sLSTM core as the layer's ``is_mlstm`` flag says, no MLP).

Parameters live in one flat fp32 vector (P,), and a cohort of m client
models is one (m, P) tensor, as for the MLP.  ``TransformerLayout`` gives
the reference's parameter tree as views of either: ``{"layers": [{
"norm1_scale", ..., "attn": {wq, wk, wv, wo}, "mlp": {w_up, w_down}}, ...],
"final_norm_*", "embed", "head"}`` (a hymba layer adds ``"ssm": {...}``,
``attn_out_norm`` and ``ssm_out_norm``; an xlstm layer is ``{"xlstm": {w_up,
wq, wk, wv, w_if, b_if, w_down, core_norm}, "norm1"}``; an MLA layer's
``"attn"`` is ``init_mla``'s, an MoE layer's ``"mlp"`` is ``init_moe``'s; the
MTP head adds ``mtp_proj`` and ``mtp_norm``), each leaf with the
reference's shape behind the leading client axis, if any.  The views come from one
``torch.split``, so the gradient of the flat vector is assembled by one
concatenation rather than one full-size scatter per leaf.

``forward`` takes tokens (..., S) with weights (P,) shared by the whole
batch (poll, evaluation), or tokens (m, B, S) with weights (m, P), one set
per client (local SGD); or the embedded inputs (..., S, d) that
``embed_inputs`` makes of a batch dict.  Client and batch axes fold into
one batch axis for attention, which runs through the flash-attention
kernel on the card, and into the rows of the selective-scan kernel for
the Mamba heads.
The reference computes both xLSTM cores in every layer and keeps one with
``jnp.where``; the port computes only the flagged one, which gives the
same output and gradient.  The reference's ``remat`` (``jax.checkpoint``
per layer) changes no number and is not mapped.  An MoE layer returns its
router's load-balance loss; ``forward(..., with_aux=True)`` returns the
layers' mean of it, which ``loss_fn`` and the LM task weight by
``router_aux_weight``.

``mesh`` (a ``repro_torch.launch.mesh.Mesh``, None by default) is threaded
through ``forward``, ``loss_fn``, ``prefill`` and ``decode_step`` as in the
reference: without one, or with ``cfg.moe.impl == "dense"``, an MoE layer
runs ``moe_dense``; with one and ``impl == "capacity"`` it runs
``_run_moe``'s capacity dispatch, expert-parallel over the mesh's
processes, each of which holds the whole parameter tree and the same
tokens and takes its experts as views.  Per-client weights do not take a
mesh.  The reference's ``_act_constraint`` and ``_cache_constraint`` are
layout hints to XLA that change no value; the cache's layout on a grid is
``init_cache(..., mesh=)``'s (below).
``transformer_specs`` and ``cache_specs`` name each leaf's logical axes
with the reference's structure (the layers stacked under one "layers"
axis, where the port's tree keeps a list of layers).

Inputs come in the reference's three modes (``cfg.input_mode``):
``tokens``; ``frames`` (musicgen-large: precomputed frame embeddings at
d_model, RMS-normed by the fp32 ``frame_norm`` leaf whatever the blocks'
norm, the ``embed`` table kept as the output code table that decoding
feeds back); ``vlm`` (internvl2-1b: ``n_patches`` patch embeddings in
front of the text tokens' embeddings, the loss masked to the text
positions).  ``embed_inputs`` turns a batch dict into (x, loss mask or
None).  The flat fp32 layout of federated training takes token inputs
only, as the reference's LM task does; the parameter tree (the launcher
and serving) takes all three.

``loss_fn`` is the training launcher's loss on the parameter tree: the
next-token cross-entropy over sequence chunks of ``loss_chunk``, weighted
by the loss mask and divided by its sum, each chunk's logits in fp32
(``chunked_logits_sum``, which the LM task shares), plus the MoE aux term
and, with ``cfg.mtp``, the MTP head's weighted cross-entropy against the
labels shifted by one more position.

Storage sharding: on a grid (``data`` or ``model`` larger than 1) every
family (``shards_storage``: the dense GQA models, hymba, xlstm, the frame
and patch inputs of musicgen-large and internvl2-1b, and the MoE / MLA /
MTP models dbrx-132b and deepseek-v3-671b) takes a rank's
blocks of every leaf under the baseline policy (``sharding.shard_tree``)
and the rank's ``data`` share of the batch, as the reference's layout
puts them on a device, and compute tensor-parallel over ``model``
(``embed_inputs(..., tp=mesh)``, ``forward(..., tp=mesh)``): GQA on the
rank's heads (``attention.gqa_attention``'s rules), hymba's Mamba heads
on the rank's channels (``ssm.mamba_seq``: ``w_in`` gathered whole and
cut to the rank's columns of both halves, B and C summed over ``model``
forward and backward, K4 on the rank's (B, S, D / model) block), the
xLSTM cores on the rank's heads (``ssm.mlstm_seq`` / ``slstm_seq``:
``w_up`` gathered whole, ``core_in`` whole and the out_gate on the
rank's channels, ``core_norm``'s sum of squares over ``model`` both
ways), the MLP's ``w_gate`` / ``w_up`` column blocks and ``w_down`` row block with
the output summed over ``model``, the vocab-parallel embedding (a token
outside the rank's rows reads zero; the rows summed over ``model``; the
tied table's sqrt(d) after the sum, in the table's type; vlm's patches in
front of the summed rows; frames RMS-normed by the replicated
``frame_norm``, the untied ``embed`` table then read by nothing, its
blocks' gradient zero) and the vocab-parallel cross-entropy, chunk by
chunk (local fp32 logits (..., c, V / model), the row maximum, the sum of
exponentials and the gold logit each over ``model``; the tied head is
the embedding's block transposed).  Where ``model`` does not divide the
vocab (hymba's 32001, internvl2's 151655) the table and head stay whole
and the cross-entropy is computed replicated over ``model``.  The loss
divides by the mask's sum over the data axes (vlm: the text positions),
and every leaf, replicated over them, takes its gradient summed over
them: each rank's backward ends with the gradient of its blocks for the
mean over the whole batch.  An MoE layer runs on the rank's experts
(``_moe_blocks``: the experts over ``model``, their FFN columns over
``data``; under a mesh the reference's four capacity rules, rule 1's
experts exchanged whole from the blocks by an all-to-all on every call,
the FFN columns gathered over ``data`` where a rule needs them whole and
the gradient reduce-scattered back, the tokens gathered over the data
axes where the rule replicates them; without one, or ``impl="dense"``,
``moe_dense``'s function on the rank's experts; the shared expert
tensor-parallel over ``model``), with the router's aux loss over the
whole batch; MLA on the rank's heads (``attention.mla_attention(...,
tp=)``); the MTP head through the vocab-parallel cross-entropy.  An
expert leaf's gradient is not summed over ``data``, which splits its
columns (``_sum_replicated``).  The ``fsdp`` variant's layout (the dry
run's) holds every leaf whole.

Serving on a grid, for the same families: ``init_cache(...,
mesh=)`` builds the rank's block of each cache leaf under the baseline
policy (``cache_layout``: rows over the data axes where they divide the
batch; else, where they divide the cache's length, the k / v sequence
over them (``seq_block``), as the reference's decode constraint lays it
out; kv heads over ``model`` where it divides them; MLA's latent and
k_rope, which have no head axis, and hymba's Mamba state and conv tail and
the xLSTM states whole over ``model``);
``prefill(..., mesh=)`` takes the rank's rows (``batch_rows``) and runs
``forward(..., tp=mesh)``, writes the rank's k and v (every kv head where
the cache holds them all; on a split sequence the prompt's positions in
the rank's block) and gathers the recurrent states over ``model`` into
its block; ``decode_step(..., mesh=)`` takes every row of the token
batch, as the reference replicates it, and steps the cache block's rows:
the vocab-parallel lookup, GQA on the rank's q and kv heads
(``attention.gqa_decode(..., tp=)``, ``wo``'s row block summed over
``model``; on a split sequence the partial softmax of the rank's block
combined over the data axes), the Mamba heads on the rank's channels and
the xLSTM cores on its heads (``ssm.mamba_decode`` / ``mlstm_decode`` /
``slstm_decode(..., tp=)``, their states brought back whole over
``model`` each step), MLA's absorbed scores on the rank's heads (on a
split sequence the partial softmaxes and weighted latent contexts
combined over the data axes before ``wkv_b``'s value half), the MLP's or
the MoE's blocks.  Both return the logits
replicated, as the reference's steps do: the vocab-parallel head's
blocks gathered over ``model``, the rows over the data axes.

Serving (``init_params``, ``init_cache``, ``prefill``, ``decode_step``) and
the training launcher run the model in the config's dtype, bf16 at full
size as the reference trains and serves it: ``init_params`` builds the
parameter tree leaf by leaf, the norm scales, the Mamba heads' ``a_log``,
``w_dt``, ``b_dt``, ``d_skip``, the xLSTM gate weights and the MoE router in
fp32 and every other leaf in ``cfg.dtype``, as the reference's init keeps
them (never the flat fp32 vector, which for qwen3-14b would need 59 GB
beside the 29.5 GB tree).  The cache has the reference's stacked (L, B,
...) layout (MLA: the latent and the shared rotary key, not per-head keys
and values); ``decode_step`` writes each layer's new entries into it in
place.  For xlstm only the flagged core's
state is computed and advanced; the other keeps its ``init_cache`` value,
which is what the reference's ``jnp.where`` selection leaves there.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (
    gqa_attention,
    gqa_decode,
    gqa_shapes,
    gqa_specs,
    init_gqa,
    init_mla,
    mla_attention,
    mla_decode,
    mla_shapes,
    mla_specs,
)
from repro_torch.models.common import (
    activation,
    column_in,
    layer_norm,
    lecun_init,
    linear,
    per_client,
    rms_norm,
    rope_table,
    row_out,
)

__all__ = [
    "TransformerLayout", "check_supported", "shards_storage", "param_blocks", "layer_flags",
    "init_transformer", "init_params", "init_param_blocks",
    "abstract_params",
    "transformer_specs", "cast_params", "embed_inputs", "forward", "output_head",
    "chunked_logits_sum", "token_nll", "loss_fn", "init_cache", "cache_specs", "cache_layout",
    "batch_rows", "seq_block", "prefill", "decode_step",
]


def check_supported(cfg, tree: bool = False) -> None:
    """Raise for what the port does not run: the flat fp32 layout
    (federated training) takes float32 configs with token inputs, the
    parameter tree (``tree``: the training launcher and serving) float32
    and bfloat16 and every input mode.  On a grid every config takes the
    rank's blocks of the tree (``shards_storage``) in ``loss_fn``,
    ``init_cache``, ``prefill`` and ``decode_step``."""
    if not tree and cfg.input_mode != "tokens":
        raise ValueError(
            f"repro_torch's flat transformer layout (federated training) takes token inputs "
            f"only, as the reference's LM task does; model {cfg.name!r} has "
            f"input_mode={cfg.input_mode!r} (the parameter tree of the launcher and serving "
            f"takes it)")
    dtypes = ("float32", "bfloat16") if tree else ("float32",)
    unsupported = [
        (cfg.block_type not in ("attn", "hymba", "xlstm"), f"block_type={cfg.block_type!r}"),
        (cfg.block_type == "hymba" and (cfg.ssm is None or cfg.ssm.family != "mamba"),
         "a hymba block without a mamba SSM config"),
        (cfg.block_type == "xlstm" and (cfg.ssm is None or cfg.ssm.family != "xlstm"),
         "an xlstm block without an xlstm SSM config"),
        (cfg.input_mode not in ("tokens", "frames", "vlm"), f"input_mode={cfg.input_mode!r}"),
        (cfg.dtype not in dtypes,
         f"dtype={cfg.dtype!r} (the parameter tree takes float32 and bfloat16)" if tree else
         f"dtype={cfg.dtype!r} for federated training (the flat layout trains in float32; "
         f"the launcher and serving take bfloat16 on the parameter tree)"),
    ]
    for bad, what in unsupported:
        if bad:
            raise ValueError(f"repro_torch's transformer does not implement {what} yet "
                             f"(model {cfg.name!r}); the JAX package repro runs it")


def shards_storage(cfg, mesh) -> bool:
    """Whether a rank of ``mesh`` holds ``cfg``'s leaves as its blocks under
    the baseline policy (``sharding.shard_tree``) and computes on them
    (``loss_fn``, ``init_cache``, ``prefill``, ``decode_step``): on a grid
    (``data`` or ``model`` larger than 1), for every family the port runs
    (``check_supported``): the dense GQA models, hymba-1.5b, xlstm-125m,
    musicgen-large (frames), internvl2-1b (patches) and the MoE / MLA /
    MTP models dbrx-132b and deepseek-v3-671b."""
    return bool(mesh is not None and getattr(mesh, "grid", False))


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


def _attn_shapes(cfg) -> dict[str, tuple[int, ...]]:
    return mla_shapes(cfg) if cfg.use_mla else gqa_shapes(cfg)


def _ffn_shapes(cfg) -> dict[str, tuple[int, ...]]:
    return moe_mod.moe_shapes(cfg) if cfg.moe else _mlp_shapes(cfg)


def _leaf_entries(cfg) -> list[tuple[tuple, tuple[int, ...]]]:
    """(path, shape) of every leaf of the parameter tree, in
    ``TransformerLayout``'s order (without a frames model's
    ``frame_norm``, which the flat layout does not hold)."""
    entries: list[tuple[tuple, tuple[int, ...]]] = []
    for i in range(cfg.n_layers):
        if cfg.block_type == "xlstm":
            for name, shape in ssm_mod.xlstm_shapes(cfg).items():
                entries.append((("layers", i, "xlstm", name), shape))
            for name, shape in _norm_shapes(cfg, "norm1").items():
                entries.append((("layers", i, name), shape))
            continue
        for name, shape in _norm_shapes(cfg, "norm1").items():
            entries.append((("layers", i, name), shape))
        for name, shape in _attn_shapes(cfg).items():
            entries.append((("layers", i, "attn", name), shape))
        if cfg.block_type == "hymba":
            for name, shape in ssm_mod.mamba_shapes(cfg).items():
                entries.append((("layers", i, "ssm", name), shape))
            for name in ("attn_out_norm", "ssm_out_norm"):
                entries.append((("layers", i, name), (cfg.d_model,)))
        for name, shape in _norm_shapes(cfg, "norm2").items():
            entries.append((("layers", i, name), shape))
        for name, shape in _ffn_shapes(cfg).items():
            entries.append((("layers", i, "mlp", name), shape))
    for name, shape in _norm_shapes(cfg, "final_norm").items():
        entries.append(((name,), shape))
    entries.append((("embed",), (cfg.vocab, cfg.d_model)))
    if not cfg.tie_embeddings:
        entries.append((("head",), (cfg.d_model, cfg.vocab)))
    if cfg.mtp:
        entries.append((("mtp_proj",), (cfg.d_model, cfg.d_model)))
        entries.append((("mtp_norm",), (cfg.d_model,)))
    return entries


def _set_leaf(tree: dict, path: tuple, leaf) -> None:
    node = tree
    for key in path[:-1]:
        node = node[key] if isinstance(key, int) else node.setdefault(key, {})
    node[path[-1]] = leaf


class TransformerLayout:
    """Where each parameter of the reference's tree sits in the flat
    vector: layer by layer (norm1, attn, for hymba ssm, attn_out_norm and
    ssm_out_norm, then norm2, mlp; for xlstm the block, then norm1), then
    the final norm, the embedding, the untied head and the MTP head."""

    def __init__(self, cfg):
        check_supported(cfg)
        self.cfg = cfg
        self.entries = _leaf_entries(cfg)
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
            _set_leaf(tree, path, part.unflatten(-1, shape))
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
# Logical-axis specs
# ---------------------------------------------------------------------------


def _norm_specs(cfg, name) -> dict:
    if cfg.norm == "layernorm":
        return {name + "_scale": (None,), name + "_bias": (None,)}
    return {name: (None,)}


def _mlp_specs(cfg) -> dict:
    s = {"w_up": ("embed", "ffn"), "w_down": ("ffn", "embed")}
    if cfg.mlp_activation in ("swiglu", "geglu"):
        s["w_gate"] = ("embed", "ffn")
    return s


def _layer_specs(cfg) -> dict:
    if cfg.block_type == "xlstm":
        return {"xlstm": ssm_mod.xlstm_specs(cfg), **_norm_specs(cfg, "norm1")}
    s = {**_norm_specs(cfg, "norm1"), **_norm_specs(cfg, "norm2")}
    s["attn"] = mla_specs(cfg) if cfg.use_mla else gqa_specs(cfg)
    if cfg.block_type == "hymba":
        s["ssm"] = ssm_mod.mamba_specs(cfg)
        s["attn_out_norm"] = (None,)
        s["ssm_out_norm"] = (None,)
    s["mlp"] = moe_mod.moe_specs(cfg) if cfg.moe else _mlp_specs(cfg)
    return s


def _stacked(tree):
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    return ("layers",) + tuple(tree)


def transformer_specs(cfg) -> dict:
    """The logical axes of every leaf, the reference's tree: one layer's
    axes behind a leading "layers" axis under "layers" (each of the
    port's per-layer dicts has that layer's leaves, the same keys), then
    the final norm, "embed", a frames model's "frame_norm", the untied
    "head" and the MTP head."""
    s = {"layers": _stacked(_layer_specs(cfg)), **_norm_specs(cfg, "final_norm")}
    s["embed"] = ("vocab", "embed")
    if cfg.input_mode not in ("tokens", "vlm"):
        s["frame_norm"] = (None,)
    if not cfg.tie_embeddings:
        s["head"] = ("embed", "vocab")
    if cfg.mtp:
        s["mtp_proj"] = ("embed", "embed2")
        s["mtp_norm"] = (None,)
    return s


def cache_specs(cfg) -> dict:
    """The logical axes of ``init_cache``'s leaves (the xLSTM states as
    lists, as the reference's are, so that a tree walk stops at the axis
    tuples)."""
    if cfg.block_type == "xlstm":
        return {
            "mlstm": [("layers", "batch", None, None, None), ("layers", "batch", None, None),
                      ("layers", "batch", None)],
            "slstm": [("layers", "batch", None, None), ("layers", "batch", None, None),
                      ("layers", "batch", None)],
        }
    s: dict = {}
    if cfg.use_mla:
        s["latent"] = ("layers", "batch", "seq", None)
        s["k_rope"] = ("layers", "batch", "seq", None)
    else:
        s["k"] = ("layers", "batch", "seq", "kv_heads", None)
        s["v"] = ("layers", "batch", "seq", "kv_heads", None)
    if cfg.block_type == "hymba":
        s["ssm_h"] = ("layers", "batch", None, None)
        s["conv"] = ("layers", "batch", None, None)
    return s


def param_blocks(params, cfg, mesh):
    """This rank's blocks of the parameter tree (``init_params``' or
    ``abstract_params``') under the baseline policy's storage specs on
    ``mesh`` (``sharding.shard_tree``): what a rank of a family that
    ``shards_storage`` holds."""
    from repro_torch.sharding import make_policy, shard_tree

    return shard_tree(params, make_policy(mesh, 0).shardings(transformer_specs(cfg), params),
                      mesh)


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


def _keeps_fp32(name: str, leaf: torch.Tensor | tuple) -> bool:
    """Whether the reference keeps this leaf (a tensor, or its shape) in
    fp32 in a model of another dtype: every vector (norm scales and biases,
    the Mamba heads' dt weight and bias and skip, the xLSTM gate bias),
    ``a_log``, the xLSTM gate weights ``w_if`` and the MoE router."""
    ndim = len(leaf) if isinstance(leaf, tuple) else leaf.ndim
    return ndim == 1 or name in ("a_log", "w_if", "router")


def cast_params(tree, dtype: torch.dtype):
    """A parameter tree (or subtree) with each leaf in the type the
    reference gives it in a model of ``dtype``; leaves already of that type
    are kept, not copied."""
    if isinstance(tree, list):
        return [cast_params(v, dtype) for v in tree]
    return {k: cast_params(v, dtype) if isinstance(v, (dict, list))
            else v if _keeps_fp32(k, v) else v.to(dtype) for k, v in tree.items()}


def _init_tree(generator: torch.Generator, cfg, dtype: torch.dtype, keep=None) -> dict:
    """The parameter tree drawn from ``generator`` on its device with the
    reference's distributions, each module cast to ``dtype`` (by
    ``cast_params``) as soon as it is drawn, an MoE block leaf by leaf.
    ``keep(path, leaf)``: what is kept of each leaf (``init_param_blocks``:
    the rank's block), applied to a module's leaves as soon as it is cast,
    to an MoE block's as soon as each is drawn."""
    dev = generator.device
    keep = keep or (lambda path, leaf: leaf)

    def kept(module, path):
        return {k: kept(v, (*path, k)) if isinstance(v, dict) else keep((*path, k), v)
                for k, v in module.items()}

    layers = []
    for i in range(cfg.n_layers):
        at = ("layers", i)
        if cfg.block_type == "xlstm":
            layers.append(kept({"xlstm": cast_params(ssm_mod.init_xlstm(generator, cfg), dtype),
                                **_init_norm(cfg, "norm1", dev)}, at))
            continue
        layer = kept({**_init_norm(cfg, "norm1", dev), **_init_norm(cfg, "norm2", dev)}, at)
        layer["attn"] = kept(cast_params((init_mla if cfg.use_mla else init_gqa)(generator, cfg),
                                         dtype), (*at, "attn"))
        if cfg.block_type == "hymba":
            layer["ssm"] = kept(cast_params(ssm_mod.init_mamba(generator, cfg), dtype),
                                (*at, "ssm"))
            layer |= kept({"attn_out_norm": torch.zeros(cfg.d_model, device=dev),
                           "ssm_out_norm": torch.zeros(cfg.d_model, device=dev)}, at)
        layer["mlp"] = (moe_mod.init_moe(generator, cfg, dtype,
                                         lambda name, leaf, at=at: keep((*at, "mlp", name), leaf))
                        if cfg.moe else kept(cast_params(_init_mlp(generator, cfg), dtype),
                                             (*at, "mlp")))
        layers.append(layer)
    tree = {"layers": layers, **kept(_init_norm(cfg, "final_norm", dev), ())}
    if cfg.input_mode == "frames":
        tree |= kept({"frame_norm": torch.zeros(cfg.d_model, device=dev)}, ())
    tree |= kept({"embed": (torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                                        device=dev) * 0.02).to(dtype)}, ())
    if not cfg.tie_embeddings:
        tree |= kept({"head": lecun_init(generator, (cfg.d_model, cfg.vocab)).to(dtype)}, ())
    if cfg.mtp:
        tree |= kept({"mtp_proj": lecun_init(generator, (cfg.d_model, cfg.d_model)).to(dtype),
                      "mtp_norm": torch.zeros(cfg.d_model, device=dev)}, ())
    return tree


def init_transformer(generator: torch.Generator, cfg) -> torch.Tensor:
    """Flat (P,) fp32 initial parameters drawn from ``generator`` on its
    device, with the reference's distributions: LeCun projections, unit
    LayerNorm scales (zero RMSNorm scales), zero biases, N(0, 0.02^2)
    embedding, LeCun head; a hymba layer's Mamba heads as ``init_mamba``
    draws them and zero scales for its two output norms; an xlstm layer's
    block as ``init_xlstm`` draws it; MLA, MoE and the MTP head as
    ``init_mla``, ``init_moe`` and the reference draw them."""
    layout = TransformerLayout(cfg)
    return layout.flatten(_init_tree(generator, cfg, torch.float32))


def init_params(generator: torch.Generator, cfg) -> dict:
    """The parameter tree in ``cfg.dtype`` (the training launcher's and
    serving's), drawn as ``init_transformer`` draws the flat vector (the
    same numbers, in the same order) and cast module by module, the
    reference's fp32 leaves kept in fp32; a frames model adds the zero
    fp32 ``frame_norm`` and keeps ``embed`` as its output code table."""
    check_supported(cfg, tree=True)
    return _init_tree(generator, cfg, getattr(torch, cfg.dtype))


def init_param_blocks(generator: torch.Generator, cfg, mesh) -> dict:
    """``param_blocks(init_params(generator, cfg), cfg, mesh)``, bit for
    bit, drawn leaf by leaf: each module's leaves (an MoE block's each
    leaf) cut to the rank's block as soon as they are drawn and cast, so
    that no whole tree, and no whole leaf beyond the one being drawn, is
    ever held (dbrx-132b's experts are 2.1 GB a leaf a layer in bf16)."""
    from repro_torch.sharding import shard_tree

    check_supported(cfg, tree=True)
    specs = _param_specs(cfg, mesh)

    def keep(path, leaf):
        spec = specs
        for k in path:
            spec = spec[k]
        return shard_tree(leaf, spec, mesh)

    return _init_tree(generator, cfg, getattr(torch, cfg.dtype), keep)


def abstract_params(cfg) -> dict:
    """``init_params``' tree as empty ``meta`` tensors of the same shapes
    and types, drawing nothing (the reference's ``jax.eval_shape`` of its
    init): the dry run's parameters.  ``init_params`` draws on its
    generator's device whatever the default device is, so a ``meta``
    default does not make it abstract."""
    check_supported(cfg, tree=True)
    return _abstract_tree(cfg, lambda shape, kind: torch.empty(shape, dtype=kind, device="meta"))


def _param_specs(cfg, mesh):
    """The baseline policy's spec of each leaf of ``init_params``' tree on
    ``mesh``, from the leaves' shapes alone: no tensor is made, so that a
    step that asks for them (``_loss_blocks``) allocates nothing for them,
    on the dry run's ``meta`` device either."""
    from repro_torch.sharding import make_policy

    return make_policy(mesh, 0).shardings(
        transformer_specs(cfg), _abstract_tree(cfg, lambda shape, kind: _Leaf(shape, kind, 0.0)))


def _abstract_tree(cfg, make) -> dict:
    """``init_params``' tree with ``make(shape, dtype)`` at each leaf."""
    dtype = getattr(torch, cfg.dtype)
    entries = _leaf_entries(cfg)
    if cfg.input_mode == "frames":
        at = next(i for i, (path, _) in enumerate(entries) if path == ("embed",))
        entries.insert(at, (("frame_norm",), (cfg.d_model,)))
    tree: dict = {"layers": [{} for _ in range(cfg.n_layers)]}
    for path, shape in entries:
        kind = torch.float32 if _keeps_fp32(path[-1], shape) else dtype
        _set_leaf(tree, path, make(shape, kind))
    if cfg.block_type != "xlstm":   # init_params' key order: both norms first
        order = [*_norm_shapes(cfg, "norm1"), *_norm_shapes(cfg, "norm2"), "attn", "ssm",
                 "attn_out_norm", "ssm_out_norm", "mlp"]
        tree["layers"] = [{k: layer[k] for k in order if k in layer} for layer in tree["layers"]]
    return tree


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _norm(p, cfg, x, name):
    if cfg.norm == "layernorm":
        return layer_norm(x, per_client(p[name + "_scale"], x), per_client(p[name + "_bias"], x),
                          cfg.norm_eps)
    return rms_norm(x, per_client(p[name], x), cfg.norm_eps)


def _mlp(p, cfg, x, tp=None, width=None):
    """The dense MLP (hidden ``width``, by default ``cfg.d_ff``); with
    ``tp`` (a mesh) and ``w_up`` split over its ``model`` axis, on the
    rank's column blocks of ``w_gate`` / ``w_up`` and row block of
    ``w_down``, the output summed over ``model``."""
    split = tp is not None and p["w_up"].shape[-1] != (width or cfg.d_ff)
    if split:
        x = column_in(x, tp)
    gate = linear(x, p["w_gate"]) if "w_gate" in p else None
    h = activation(cfg.mlp_activation, linear(x, p["w_up"]), gate)
    out = linear(h, p["w_down"])
    return row_out(out, tp) if split else out


def _ffn(p, cfg, x, mesh=None, tp=None, whole_rows=False):
    """The layer's MLP: (out, the router's aux loss), 0.0 for a dense one.
    ``tp``: on a rank's blocks (an MoE by ``_moe_blocks``, its capacity
    rules where ``mesh`` is given, as the reference's dispatch sees it)."""
    if cfg.moe:
        if tp is not None:
            return _moe_blocks(p, cfg, x, tp, mesh is not None and cfg.moe.impl == "capacity",
                               whole_rows)
        return _run_moe(p, cfg, x, mesh)
    return _mlp(p, cfg, x, tp), 0.0


# the most tokens for which the reference keeps the experts apart over every
# axis (or over model with their columns over the data axes) and replicates
# the tokens
_EP_TOKENS = 8192


def _local_experts(p, mesh, sync_axes, lo: int, n: int, cols=None) -> dict:
    """``p`` with its expert weights cut to experts [lo, lo + n) (and, with
    ``cols`` (c0, nc), to expert-FFN columns [c0, c0 + nc)) as views; the
    whole weights' gradients are summed over ``sync_axes`` first, so each
    process ends its backward with every slice's."""
    out = dict(p)
    for k in ("w_gate", "w_up", "w_down"):
        w = mesh.grad_sum(p[k], sync_axes).narrow(0, lo, n)
        if cols is not None:
            w = w.narrow(1 if k == "w_down" else 2, *cols)
        out[k] = w
    return out


def _ep_block(p, pl, cfg, x2d, mesh, lo: int, e_loc: int):
    """Rules 1 and 2: the capacity dispatch over this process's experts
    ``pl`` (from expert ``lo``, ``e_loc`` of them) on every token, the
    partial outputs summed over every axis, then ``p``'s shared expert."""
    all_axes = mesh.axis_names
    out2d, aux = moe_mod.moe_capacity(
        pl, cfg, x2d, expert_offset=lo, n_local_experts=e_loc, include_shared=False,
        grad_sync=lambda t: mesh.grad_sum(t, all_axes))
    out2d = mesh.all_reduce_sum(out2d, all_axes)
    if cfg.moe.n_shared:
        out2d = out2d + moe_mod._shared_expert(p, cfg, x2d)
    return out2d, aux


def _run_moe(p, cfg, x, mesh):
    """The reference's ``_run_moe``: ``moe_dense`` without a mesh or with
    ``impl="dense"``; else the capacity dispatch over the mesh's processes
    by the reference's four rules, in its order (n_dev devices, T = B x S
    tokens):

    1. T <= 8192 and n_dev | E: E / n_dev experts a process over every
       axis, the tokens replicated, the partial outputs summed over every
       axis;
    2. T <= 8192, model | E and (n_dev / model) | d_expert: E / model
       experts a process over ``model``, their FFN columns split over the
       data axes, the partial outputs summed over every axis;
    3. model does not divide E: ``moe_capacity`` on every process alike;
    4. else ``moe_capacity_sharded`` over ``model``, the batch split over
       the data axes (replicated where they do not divide B) and gathered
       after, the aux loss averaged over them.

    Every process holds the whole tree and all B tokens; each block sees
    the tokens the reference's block sees, since the capacity depends on
    their count.  Under autograd every process ends with the whole
    gradient: each value used for a part that is summed over processes
    sums its gradient over them (``Mesh.grad_sum``).  x (B, S, d) -> (out,
    aux)."""
    if cfg.moe.impl == "dense" or mesh is None:
        return moe_mod.moe_dense(p, cfg, x)
    if p["router"].ndim != 2 or x.ndim != 3:
        raise ValueError("the MoE under a mesh takes one model's weights and x (B, S, d); "
                         "per-client weights run without a mesh")
    if mesh.coords is None:
        raise ValueError(f"the MoE under a mesh needs one process a device; this process "
                         f"holds {len(mesh.pods)} pods of {mesh.shape}")
    mc = cfg.moe
    all_axes = mesh.axis_names
    n_dev, model = mesh.size(), mesh.shape["model"]
    dp_all = tuple(a for a in all_axes if a != "model")
    b, s, d = x.shape
    x2d = x.reshape(-1, d)
    rule = _ep_rule(cfg, mesh, b * s)
    if rule == 1:
        # experts over every axis
        e_loc = mc.n_experts // n_dev
        lo = mesh.index(all_axes) * e_loc
        out2d, aux = _ep_block(p, _local_experts(p, mesh, all_axes, lo, e_loc), cfg, x2d, mesh,
                               lo, e_loc)
        return out2d.reshape(b, s, d), aux
    if rule == 2:
        # experts over model, their FFN columns over the data axes
        e_loc, fe = mc.n_experts // model, mc.d_expert // (n_dev // model)
        lo = mesh.axis_index("model") * e_loc
        pl = _local_experts(p, mesh, all_axes, lo, e_loc, (mesh.index(dp_all) * fe, fe))
        out2d, aux = _ep_block(p, pl, cfg, x2d, mesh, lo, e_loc)
        return out2d.reshape(b, s, d), aux
    if rule == 3:                           # replicated
        out, aux = moe_mod.moe_capacity(p, cfg, x2d)
        return out.reshape(x.shape), aux
    # experts over model, tokens over the data axes
    dp = dp_all if b % mesh.size(dp_all) == 0 else ()
    e_loc = mc.n_experts // model
    pl = _local_experts(p, mesh, ("model",) + dp, mesh.axis_index("model") * e_loc, e_loc)
    if dp:
        # this process's piece of the batch uses the router and the shared
        # expert for that piece only: their gradients sum over the data axes
        for k in ("router", "shared_gate", "shared_up", "shared_down"):
            if k in pl:
                pl[k] = mesh.grad_sum(pl[k], dp)
        b_loc = b // mesh.size(dp)
        x = mesh.grad_sum(x, dp).narrow(0, mesh.index(dp) * b_loc, b_loc)
    out, aux = moe_mod.moe_capacity_sharded(pl, cfg, x, mesh, mesh_axis="model")
    if dp:
        aux = mesh.all_reduce_mean(aux, dp)
        out = mesh.all_gather(out, dp, dim=0)
    return out, aux


def _ep_rule(cfg, mesh, t: int) -> int:
    """Which of ``_run_moe``'s four rules the reference takes for ``t``
    tokens on ``mesh``."""
    mc, n_dev, model = cfg.moe, mesh.size(), mesh.shape["model"]
    if t <= _EP_TOKENS and mc.n_experts % n_dev == 0:
        return 1
    if t <= _EP_TOKENS and mc.n_experts % model == 0 \
            and mc.d_expert % (n_dev // model) == 0:
        return 2
    return 3 if mc.n_experts % model else 4


_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _col_dim(name: str) -> int:
    """The dimension of an expert leaf that holds its expert-FFN columns."""
    return 1 if name == "w_down" else 2


def _expert_columns(p, cfg, mesh, partial: bool = True) -> dict:
    """The rank's expert blocks with their expert-FFN columns gathered whole
    over ``data``, where the policy splits them (``expert_ff``); backward,
    the gradient summed over ``data`` and cut back to the block (the
    matching reduce-scatter), or, where each data rank computes every row
    (not ``partial``), only cut."""
    out = {}
    for k in _EXPERT_LEAVES:
        w, dim = p[k], _col_dim(k)
        if w.shape[dim] != cfg.moe.d_expert:
            w = mesh.all_gather(w, "data", dim=dim)
            w = mesh.grad_sum(w, "data") if partial else w
        out[k] = w
    return out


def _experts_exchanged(p, cfg, mesh, lo: int, e_loc: int) -> dict:
    """Rule 1's experts [lo, lo + e_loc) whole on this rank, from the blocks
    its pod's ranks store (experts over ``model``, expert-FFN columns over
    ``data``; the replicas over the other axes are not read): one
    all-to-all a leaf over every axis, in which each rank sends each
    other rank the pieces of its block that rank needs.  Backward, each
    piece's gradient goes back to the block it came from."""
    mc, names = cfg.moe, mesh.axis_names
    eb, fb = p["w_up"].shape[0], p["w_up"].shape[2]
    nm, nc = mc.n_experts // eb, mc.d_expert // fb
    me = mesh.coords
    ranks = [mesh._coords_of(r) for r in range(mesh.size())]
    rank_of = {tuple(c[a] for a in names): r for r, c in enumerate(ranks)}

    def source(at, e, j):     # the rank of ``at``'s pod holding column block j of expert e
        src = dict(at)
        if nm > 1:
            src["model"] = e // eb
        if nc > 1:
            src["data"] = j
        return src

    sent, send = [], [0] * len(ranks)
    for r, at in enumerate(ranks):
        for e in range(r * e_loc, (r + 1) * e_loc):
            for j in range(nc):
                if source(at, e, j) == me:
                    sent.append(e - me["model"] * eb if nm > 1 else e)
                    send[r] += 1
    pieces = sorted((rank_of[tuple(source(me, e, j)[a] for a in names)], e, j)
                    for e in range(lo, lo + e_loc) for j in range(nc))
    recv, at = [0] * len(ranks), {}
    for i, (r, e, j) in enumerate(pieces):
        recv[r] += 1
        at[e, j] = i
    order = [at[e, j] for e in range(lo, lo + e_loc) for j in range(nc)]
    first = sent[0] if sent else 0
    out = {}
    for k in _EXPERT_LEAVES:
        w = p[k]
        if sent == list(range(first, first + len(sent))):     # a run of the block: no copy
            part = w.narrow(0, first, len(sent))
        else:
            part = w.index_select(0, torch.tensor(sent, dtype=torch.int64, device=w.device))
        got = mesh.all_to_all(part, send, recv)
        got = got.index_select(0, torch.tensor(order, dtype=torch.int64, device=w.device))
        got = got.reshape(e_loc, nc, *w.shape[1:])
        if k == "w_down":
            out[k] = got.reshape(e_loc, nc * fb, w.shape[2])
        else:
            out[k] = got.permute(0, 2, 1, 3).reshape(e_loc, w.shape[1], nc * fb)
    return out


def _shared_blocks(p, cfg, x2d, mesh):
    """The shared expert on the rank's rows, tensor-parallel over ``model``
    as ``_mlp(tp=)`` computes the dense MLP (``shared_*`` are ``ffn``
    leaves); the reference computes it replicated over ``model``."""
    shared = {"w_gate": p["shared_gate"], "w_up": p["shared_up"], "w_down": p["shared_down"]}
    return _mlp(shared, cfg, x2d, mesh, width=cfg.moe.d_expert * cfg.moe.n_shared)


def _moe_blocks(p, cfg, x, mesh, capacity: bool, whole_rows: bool = False):
    """The MoE layer on a rank's blocks (experts over ``model``, their FFN
    columns over ``data``, the router replicated, the shared expert's
    ``ffn`` over ``model``) and its rows x (B_loc, S, d) of a batch split
    over the data axes (``whole_rows``: every row, a batch they do not
    divide) -> (out (B_loc, S, d), aux).  The router runs on the rank's
    rows.

    Without ``capacity`` (``impl="dense"``, or no mesh as the reference's
    scale-out round runs it): ``moe_dense`` on the rank's experts, their
    columns gathered over ``data``, the partial outputs summed over
    ``model`` in fp32; the aux loss over the whole batch.  With it,
    ``_run_moe``'s rule for the whole batch's tokens:

    1. the rank's E / n_dev experts whole, exchanged from its pod's blocks
       (``_experts_exchanged``), on every token;
    2. its ``model`` block of experts on the columns of its ``data``
       block that its other data axes (``pod``) give it, on every token;
    3. every expert, the columns gathered over ``data``, on every token,
       computed alike on every rank;
    4. its ``model`` block of experts, the columns gathered over ``data``,
       on its rows (the capacity of its rows' tokens), the aux loss the
       mean of the data ranks' own.

    Rules 1-3 gather the tokens and their routing over the data axes, as
    the reference replicates them, and cut the output back to the rank's
    rows; their aux loss is the whole batch's.  Gradients: each rank ends
    with its blocks' and its rows' (its rows' part of the replicated
    router's, which ``_loss_blocks`` sums over the data axes), every
    gather's backward the matching reduce-scatter; with ``whole_rows``
    every data rank computes every row, and nothing is summed over them."""
    mc, names = cfg.moe, mesh.axis_names
    rows = () if whole_rows else _data_axes(mesh)
    b, s, d = x.shape
    x2d = x.reshape(-1, d)
    t_loc = x2d.shape[0]
    t = t_loc * mesh.size(rows)
    ids, w, probs = moe_mod.route(p, cfg, x2d)
    counts, psum = moe_mod.router_sums(cfg, ids, probs)
    rule = _ep_rule(cfg, mesh, t) if capacity else 0
    if rule == 4:
        aux = mesh.all_reduce_mean(moe_mod.load_balance(cfg, counts, psum, t_loc), rows)
    else:
        aux = moe_mod.load_balance(cfg, mesh.all_reduce_sum(counts, rows),
                                   mesh.all_reduce_sum(psum, rows), t)
    model = mesh.axis_index("model")
    if rule == 0:
        pe = _expert_columns(p, cfg, mesh, bool(rows))
        e_loc = pe["w_up"].shape[0]
        wf = moe_mod.scatter_weights(cfg, ids, w, x.dtype)
        if e_loc != mc.n_experts:
            # every expert's weight feeds its model rank: the whole (T, E)
            # gradient is summed over model before the rank's slice is taken
            wf = column_in(wf, mesh).narrow(-1, model * e_loc, e_loc)
            out = row_out(moe_mod.dense_sum(pe, cfg, column_in(x2d, mesh), wf),
                          mesh).to(x.dtype)
        else:
            out = moe_mod.dense_sum(pe, cfg, x2d, wf).to(x.dtype)
    elif rule == 4:
        e_loc = mc.n_experts // mesh.shape["model"]
        out = mesh.all_reduce_sum(moe_mod.dispatched(
            _expert_columns(p, cfg, mesh, bool(rows)), cfg, x2d, ids, w,
            moe_mod.capacity(cfg, t_loc),
            model * e_loc, grad_sync=lambda v: mesh.grad_sum(v, "model")), "model")
    else:
        xa, ida, wa = (mesh.all_gather(v, rows) for v in (x2d, ids, w))
        cap = moe_mod.capacity(cfg, t)
        if rule == 3:
            out = moe_mod.dispatched(_expert_columns(p, cfg, mesh, bool(rows)), cfg, xa, ida,
                                     wa, cap)
        else:
            if rule == 1:
                e_loc = mc.n_experts // mesh.size()
                lo = mesh.index(names) * e_loc
                pl = _experts_exchanged(p, cfg, mesh, lo, e_loc)
            else:
                e_loc = mc.n_experts // mesh.shape["model"]
                lo = model * e_loc
                fb = p["w_up"].shape[2]
                other = tuple(a for a in _data_axes(mesh)
                              if not (a == "data" and fb != mc.d_expert))
                sub = mc.d_expert // mesh.size(_data_axes(mesh))
                pl = {k: p[k].narrow(_col_dim(k), mesh.index(other) * sub, sub)
                      for k in _EXPERT_LEAVES}
            out = mesh.all_reduce_sum(moe_mod.dispatched(
                pl, cfg, xa, ida, wa, cap, lo, grad_sync=lambda v: mesh.grad_sum(v, names)),
                names)
            # each rank keeps its rows: every row's cotangent reaches every partial
            out = mesh.grad_sum(out, rows)
        out = out.narrow(0, mesh.index(rows) * t_loc, t_loc)
    if mc.n_shared:
        out = out + _shared_blocks(p, cfg, x2d, mesh)
    return out.reshape(b, s, d), aux


def _lookup(table: torch.Tensor, cfg, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """The embedding table's rows of token ids (..., S) -> (..., S, d); with
    a per-client table (m, V, d) the tokens are (m, B, S) and client i
    reads its own table.  With ``tp`` (a mesh) and the table's rows split
    over its ``model`` axis, the vocab-parallel lookup: a token outside the
    rank's rows reads zero and the rows are summed over ``model``."""
    if tp is not None and table.shape[0] != cfg.vocab:
        n = table.shape[0]
        local = tokens.long() - tp.axis_index("model") * n
        inside = ((local >= 0) & (local < n)).unsqueeze(-1).to(table.dtype)
        return row_out(table[local.clamp(0, n - 1)] * inside, tp)
    if table.ndim == 2:
        return table[tokens.long()]
    rows = torch.arange(table.shape[0], device=tokens.device)
    return table[rows.view(-1, *([1] * (tokens.ndim - 1))), tokens.long()]


def _embed_tokens(params, cfg, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """Token ids (..., S) -> (..., S, d) (``_lookup``, ``tp`` likewise); a
    tied embedding scales by sqrt(d) rounded to the table's type, as the
    reference does."""
    x = _lookup(params["embed"], cfg, tokens, tp)
    if cfg.tie_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model)).to(x.dtype)
    return x


def _embed_frames(params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """Frame embeddings (..., S, d) in the model's dtype, RMS-normed by
    ``frame_norm`` (an RMS norm whatever ``cfg.norm`` is, as in the
    reference)."""
    return rms_norm(frames.to(getattr(torch, cfg.dtype)), params["frame_norm"], cfg.norm_eps)


def embed_inputs(params, cfg, batch: dict,
                 tp=None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """A batch dict -> (x (B, S, d), the loss mask (B, S) fp32, or None
    where every position counts), as the reference's ``embed_inputs``
    (``tp``: a rank's blocks, the tables' lookups vocab-parallel where
    ``model`` splits their rows, ``_lookup``):

    - tokens: {"tokens": (B, S) int}
    - frames: {"frames": (B, S, d)}
    - vlm:    {"patches": (B, n_patches, d), "tokens": (B, S - n_patches)},
      the patches cast to the table's type in front of the tokens'
      embeddings; the mask is 0 over the patches and 1 after them.
    """
    if cfg.input_mode == "tokens":
        return _embed_tokens(params, cfg, batch["tokens"], tp), None
    if cfg.input_mode == "frames":
        return _embed_frames(params, cfg, batch["frames"]), None
    if cfg.input_mode == "vlm":
        tok = _lookup(params["embed"], cfg, batch["tokens"], tp)
        x = torch.cat([batch["patches"].to(tok.dtype), tok], dim=1)
        b, s = x.shape[:2]
        mask = torch.ones(b, s, dtype=torch.float32, device=x.device)
        mask[:, :cfg.n_patches] = 0.0
        return x, mask
    raise ValueError(cfg.input_mode)


def _rope_tables(cfg, seq_len, device, positions: int | None = None):
    """Two (S, rot / 2) table pairs (local theta, global theta); with
    ``positions`` (decode) each table's row at that position.  MLA rotates
    its ``qk_rope_head_dim`` dims."""
    if cfg.use_mla:
        dim = cfg.qk_rope_head_dim
    else:
        dim = int(cfg.resolved_head_dim * cfg.rope_fraction)
        dim -= dim % 2
    if dim == 0:
        dim = 2
    tabs_l = rope_table(seq_len, dim, cfg.rope_theta, device, positions=positions)
    tabs_g = (rope_table(seq_len, dim, cfg.rope_theta_global, device, positions=positions)
              if cfg.rope_theta_global else tabs_l)
    return tabs_l, tabs_g


def _select_rope(tabs_l, tabs_g, is_global: float):
    return tabs_g if is_global > 0 else tabs_l


def _flags_at(flags, i: int) -> dict[str, float]:
    return {k: float(v[i]) for k, v in flags.items()}


def _apply_layer_seq(pl, cfg, x, flags: dict[str, float], tabs_l, tabs_g, mesh=None,
                     tp=None, all_kv=False, whole_rows=False):
    """One layer over the full sequence: attention (in parallel with the
    Mamba heads for hymba), then the MLP; for xlstm the flagged core.
    Returns (x, the router's aux loss (0.0 without MoE), the layer's decode
    cache entries).  ``tp``: the mesh whose ``model`` axis splits ``pl``
    (a rank's blocks); ``all_kv``: k and v as the cache block holds them
    (``gqa_attention``); ``whole_rows``: x holds every row of a batch that
    the data axes do not divide (``_moe_blocks``)."""
    if cfg.block_type == "xlstm":
        name = "mlstm" if flags["is_mlstm"] > 0 else "slstm"
        out, state = getattr(ssm_mod, f"{name}_seq")(pl["xlstm"], cfg, _norm(pl, cfg, x, "norm1"),
                                                     tp=tp)
        return x + out, 0.0, {name: state}
    is_global = flags["is_global"]
    sin, cos = _select_rope(tabs_l, tabs_g, is_global)
    h = _norm(pl, cfg, x, "norm1")
    if cfg.use_mla:
        a_out, (latent, k_rope) = mla_attention(pl["attn"], cfg, h, sin, cos, is_global, tp=tp)
        cache = {"latent": latent, "k_rope": k_rope}
    else:
        a_out, (k, v) = gqa_attention(pl["attn"], cfg, h, sin, cos, is_global, tp=tp,
                                      all_kv=all_kv)
        cache = {"k": k, "v": v}
    if cfg.block_type == "hymba":
        s_out, (cache["ssm_h"], cache["conv"]) = ssm_mod.mamba_seq(pl["ssm"], cfg, h, tp=tp)
        a_out = _hymba_fuse(pl, cfg, a_out, s_out)
    x = x + a_out
    m_out, aux = _ffn(pl["mlp"], cfg, _norm(pl, cfg, x, "norm2"), mesh, tp, whole_rows)
    return x + m_out, aux, cache


def _hymba_fuse(pl, cfg, a_out, s_out):
    """The mean of the attention and Mamba outputs, each RMS-normed."""
    return 0.5 * (rms_norm(a_out, per_client(pl["attn_out_norm"], a_out), cfg.norm_eps)
                  + rms_norm(s_out, per_client(pl["ssm_out_norm"], s_out), cfg.norm_eps))


def forward(params, cfg, inputs: torch.Tensor, layout: TransformerLayout | None = None,
            collect_cache: bool = False, with_aux: bool = False, mesh=None, tp=None,
            whole_rows: bool = False):
    """Hidden states after the final norm, (..., S, d).  ``params`` is the
    flat (P,) or (m, P) vector (cut by ``layout``) or its tree of views;
    ``inputs`` the token ids (..., S) or, floating point, the embedded
    inputs (..., S, d) (``embed_inputs``).
    With ``with_aux`` it also returns the MoE router's aux loss, the mean
    over the layers (fp32: one per client with per-client weights, else
    one per leading group of (B, S) tokens; a 0-d zero without MoE), as the
    reference's forward does; with ``collect_cache`` one dict of decode
    cache entries a layer, last: (hidden[, aux][, caches]).  ``mesh``:
    the MoE's device mesh (one model's weights and (B, S) inputs only).
    ``tp``: the mesh whose ``model`` axis splits ``params``, a rank's
    blocks (``shards_storage``), computed tensor-parallel (``mesh`` then
    that same mesh where the MoE dispatch sees it, None for
    ``moe_dense``'s function; ``whole_rows``: the inputs are every row of
    a batch that the data axes do not divide, else the rank's rows of
    it); the hidden states come out replicated over ``model``, and the
    cache entries are
    the rank's: k and v its cache block's kv heads, the recurrent states
    its channels or heads."""
    if isinstance(params, torch.Tensor):
        params = (layout or TransformerLayout(cfg)).views(params)
    if mesh is not None and params["embed"].ndim != 2:
        raise ValueError("per-client weights take no mesh: the reference never combines "
                         "them")
    x = inputs if inputs.is_floating_point() else _embed_tokens(params, cfg, inputs, tp)
    tabs_l, tabs_g = _rope_tables(cfg, x.shape[-2], x.device)
    flags = layer_flags(cfg)
    caches, aux = [], 0.0
    for i, pl in enumerate(params["layers"]):
        x, layer_aux, cache = _apply_layer_seq(pl, cfg, x, _flags_at(flags, i), tabs_l, tabs_g,
                                               mesh, tp, all_kv=collect_cache,
                                               whole_rows=whole_rows)
        aux = aux + layer_aux
        if collect_cache:
            caches.append(cache)
    h = _norm(params, cfg, x, "final_norm")
    out = (h,)
    if with_aux:
        aux = aux if isinstance(aux, torch.Tensor) else torch.zeros((), device=h.device)
        out += (aux / cfg.n_layers,)
    if collect_cache:
        out += (caches,)
    return out if len(out) > 1 else h


def output_head(params, cfg) -> torch.Tensor:
    """The (d, V) output projection, (m, d, V) per client: the tied
    embedding's transpose or the separate head."""
    return params["embed"].transpose(-1, -2) if cfg.tie_embeddings else params["head"]


def _logits(params, cfg, h: torch.Tensor) -> torch.Tensor:
    """h (..., d) -> logits (..., V) in the model's type."""
    return h @ output_head(params, cfg)


# ---------------------------------------------------------------------------
# Loss (sequence-chunked cross-entropy)
# ---------------------------------------------------------------------------


def chunked_logits_sum(h: torch.Tensor, head: torch.Tensor, chunk: int, per_chunk):
    """The sum of ``per_chunk(logits, lo, hi)`` over the sequence chunks
    [lo, hi) of ``chunk`` positions (or the whole sequence if shorter):
    h (..., S, d) times the head (d, V), or (m, d, V) per client with h
    (m, ..., S, d), one chunk at a time in fp32, so that the (..., S, V)
    logits never exist at once."""
    s = h.shape[-2]
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"seq_len {s} must be a multiple of loss_chunk {c}")
    tot = 0.0
    for lo in range(0, s, c):
        tot = tot + per_chunk(linear(h[..., lo:lo + c, :], head).to(torch.float32), lo, lo + c)
    return tot


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token NLL per position: fp32 logits (..., c, V) and labels
    (..., c) -> (..., c)."""
    gold = torch.gather(logits, -1, labels.to(torch.int64).unsqueeze(-1)).squeeze(-1)
    return torch.logsumexp(logits, dim=-1) - gold


def _masked_nll_sum(h, head, cfg, labels, mask):
    """sum(NLL x mask) over sequence chunks."""
    return chunked_logits_sum(
        h, head, cfg.loss_chunk,
        lambda lg, lo, hi: (token_nll(lg, labels[..., lo:hi]) * mask[..., lo:hi]).sum())


def _masked_ce(h, head, cfg, labels, mask):
    """sum(NLL x mask) / max(sum(mask), 1) over sequence chunks."""
    return _masked_nll_sum(h, head, cfg, labels, mask) / torch.clamp(mask.sum(), min=1.0)


def _vocab_parallel_nll_sum(h, head, cfg, labels, mask, mesh):
    """sum(NLL x mask) over sequence chunks with the head's vocab block
    (d, V / model) on this rank: h (..., S, d), replicated over ``model``;
    each chunk's local fp32 logits (..., c, V / model), their row maximum
    (no gradient: it cancels), sum of exponentials and gold logit (the
    owning rank's, zero elsewhere) taken over ``model``."""
    n = head.shape[-1]
    lo_v = mesh.axis_index("model") * n

    def per_chunk(lg, lo, hi):
        lab = labels[..., lo:hi].long() - lo_v
        inside = (lab >= 0) & (lab < n)
        mx = mesh.all_reduce_max(lg.detach().amax(-1), "model")
        se = row_out(torch.exp(lg - mx.unsqueeze(-1)).sum(-1), mesh)
        gold = torch.gather(lg, -1, lab.clamp(0, n - 1).unsqueeze(-1)).squeeze(-1)
        gold = row_out(gold * inside, mesh)
        return ((torch.log(se) + mx - gold) * mask[..., lo:hi]).sum()

    return chunked_logits_sum(column_in(h, mesh), head, cfg.loss_chunk, per_chunk)


def _sum_replicated(params, specs, mesh):
    """``params`` (a rank's blocks, laid out by ``specs``, their baseline
    specs) with each leaf's gradient summed over the data axes over which
    its spec replicates it: every data axis but one the spec names (an
    expert leaf's ``data``, which splits its columns, takes its sum in its
    gather's reduce-scatter instead)."""
    from repro_torch.sharding import _map

    dp = _data_axes(mesh)

    def one(spec, leaf):
        named = {a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)}
        return mesh.grad_sum(leaf, tuple(a for a in dp if a not in named))

    return _map(one, specs, params, "")


def _loss_blocks(params, cfg, batch: dict, mesh):
    """``loss_fn`` on a rank's blocks and its ``data`` share of the batch
    (``shards_storage``): each leaf's gradient summed over the data axes
    that replicate it (``_sum_replicated``; an expert leaf's columns
    split over ``data`` take their sum in their gather's reduce-scatter),
    the loss the mean over the whole batch, the same on every rank; the
    aux term and the MTP head's cross-entropy (vocab-parallel, as the
    trunk's) as ``loss_fn`` adds them."""
    dp = _data_axes(mesh)
    params = _sum_replicated(params, _param_specs(cfg, mesh), mesh)
    labels = batch["labels"]
    x, mask = embed_inputs(params, cfg, batch, tp=mesh)
    h, aux = forward(params, cfg, x, with_aux=True, mesh=mesh, tp=mesh)
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    head = output_head(params, cfg)

    def ce_of(h, labels, mask):
        if head.shape[-1] != cfg.vocab:
            tot = _vocab_parallel_nll_sum(h, head, cfg, labels, mask, mesh)
        else:                              # the head whole: computed replicated over model
            tot = _masked_nll_sum(h, head, cfg, labels, mask)
        count = mesh.all_reduce_sum(mask.sum(), dp)
        return mesh.all_reduce_sum(tot / torch.clamp(count, min=1.0), dp)

    ce = ce_of(h, labels, mask)
    loss, metrics = ce, {"ce": ce, "aux": aux}
    if cfg.moe:
        loss = loss + cfg.moe.router_aux_weight * aux
    if cfg.mtp:
        mtp_ce = ce_of(*_mtp_inputs(params, cfg, h, labels, mask))
        loss = loss + cfg.mtp_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    return loss, metrics


def _mtp_inputs(params, cfg, h, labels, mask):
    """The MTP head's hidden states, labels and mask: rms_norm(h @
    mtp_proj, mtp_norm) against the labels shifted one more position, the
    last position masked."""
    s = h.shape[-2]
    h_mtp = rms_norm(h @ params["mtp_proj"], params["mtp_norm"], cfg.norm_eps)
    m2 = mask * (torch.arange(s, device=h.device) < s - 1).to(torch.float32)
    return h_mtp, torch.roll(labels, -1, dims=-1), m2


def loss_fn(params, cfg, batch: dict, mesh=None, sharded: bool | None = None):
    """The mean next-token cross-entropy of ``batch`` (``embed_inputs``'s
    dict and "labels" (B, S)) under the parameter tree, each position
    weighted by the loss mask (vlm: the text positions) and divided by the
    mask's sum; plus ``router_aux_weight`` x the MoE aux loss and, with
    ``cfg.mtp``, ``mtp_weight`` x the MTP head's cross-entropy:
    rms_norm(h @ mtp_proj, mtp_norm) against the labels shifted one more
    position, the last position masked too.  Returns (loss, {"ce",
    "aux"[, "mtp_ce"]}).

    ``sharded`` (by default ``shards_storage(cfg, mesh)``): ``params`` are
    this rank's blocks of the tree and ``batch`` its ``data`` share, as the
    module's docstring says; False keeps every leaf whole on every rank
    (the launcher's layout)."""
    if sharded is None:
        sharded = shards_storage(cfg, mesh)
    if sharded:
        return _loss_blocks(params, cfg, batch, mesh)
    labels = batch["labels"]
    x, mask = embed_inputs(params, cfg, batch)
    h, aux = forward(params, cfg, x, with_aux=True, mesh=mesh)
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    head = output_head(params, cfg)
    ce = _masked_ce(h, head, cfg, labels, mask)
    loss = ce
    metrics = {"ce": ce, "aux": aux}
    if cfg.moe:
        loss = loss + cfg.moe.router_aux_weight * aux
    if cfg.mtp:
        h_mtp, y2, m2 = _mtp_inputs(params, cfg, h, labels, mask)
        mtp_ce = _masked_ce(h_mtp, head, cfg, y2, m2)
        loss = loss + cfg.mtp_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving: cache init, prefill, decode
# ---------------------------------------------------------------------------


class _Leaf:
    """A cache leaf's shape, type and fill, allocating nothing: the layout of
    a cache whose whole leaves no rank holds."""

    __slots__ = ("shape", "dtype", "fill")

    def __init__(self, shape, dtype, fill):
        self.shape, self.dtype, self.fill = tuple(shape), dtype, fill


def _cache_tree(cfg, batch_size: int, max_len: int, make) -> dict:
    """``init_cache``'s structure, each leaf ``make(shape, dtype, fill)``."""
    n_layers, d = cfg.n_layers, cfg.d_model
    f32 = torch.float32
    if cfg.block_type == "xlstm":
        hh = cfg.ssm.n_heads
        hd = d // hh
        lead = (n_layers, batch_size, hh)
        return {
            "mlstm": (make((*lead, hd, hd), f32, 0.0), make((*lead, hd), f32, 0.0),
                      make(lead, f32, ssm_mod._NEG)),
            "slstm": (make((*lead, hd), f32, 0.0), make((*lead, hd), f32, 0.0),
                      make(lead, f32, ssm_mod._NEG)),
        }
    dt = getattr(torch, cfg.dtype)
    seq = (n_layers, batch_size, max_len)
    if cfg.use_mla:
        cache = {"latent": make((*seq, cfg.kv_lora_rank), dt, 0.0),
                 "k_rope": make((*seq, cfg.qk_rope_head_dim), dt, 0.0)}
    else:
        kv_shape = (*seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache = {"k": make(kv_shape, dt, 0.0), "v": make(kv_shape, dt, 0.0)}
    if cfg.block_type == "hymba":
        cache["ssm_h"] = make((n_layers, batch_size, d, cfg.ssm.d_state), f32, 0.0)
        cache["conv"] = make((n_layers, batch_size, cfg.ssm.conv_kernel - 1, d), f32, 0.0)
    return cache


def init_cache(cfg, batch_size: int, max_len: int, device=None, mesh=None) -> dict:
    """The stacked (L-leading) decode cache: k and v (L, B, max_len, KV,
    hd) in ``cfg.dtype`` (MLA: ``latent`` (L, B, max_len, kv_lora_rank) and
    ``k_rope`` (L, B, max_len, qk_rope_head_dim)), with hymba's Mamba
    state ``ssm_h`` (L, B, D, N) and conv tail ``conv`` (L, B, k - 1, D);
    for xlstm the mLSTM state (C (L, B, H, hd, hd), n (L, B, H, hd), m (L,
    B, H)) and the sLSTM state (c, n (L, B, H, hd), m (L, B, H)).  States
    are fp32, m starts at -1e30, everything else at 0.

    ``mesh``: for the families of ``shards_storage`` on a grid, this rank's
    block of each leaf (``cache_layout``), the rows of ``batch_rows`` and,
    where the data axes split the sequence, the positions of
    ``seq_block``; the whole leaves are never allocated."""
    check_supported(cfg, tree=True)

    def make(shape, dtype, fill):
        return torch.full(shape, fill, dtype=dtype, device=device)

    if not shards_storage(cfg, mesh):
        return _cache_tree(cfg, batch_size, max_len, make)
    from repro_torch.sharding import shard_shape, spec_leaves

    leaves, spec = tree_flatten(_cache_tree(cfg, batch_size, max_len, _Leaf))
    specs = spec_leaves(cache_layout(cfg, mesh, batch_size, max_len))
    return tree_unflatten([make(shard_shape(mesh, sp, leaf.shape), leaf.dtype, leaf.fill)
                           for sp, leaf in zip(specs, leaves, strict=True)], spec)


def cache_layout(cfg, mesh, batch_size: int, max_len: int):
    """The spec of each leaf of ``init_cache``'s whole cache for a batch of
    ``batch_size`` and ``max_len`` positions on ``mesh``, by the rule of
    the reference's decode constraint on a layer's k / v leaf (B, S, KV,
    hd): rows over the data axes where they divide the batch; else the
    sequence over them where they divide ``max_len`` (a batch of one, or
    one they do not divide: ``seq_block``, the baseline policy's
    ``shard_seq``); else whole.  kv heads over ``model`` where it divides
    them.  hymba's Mamba state and conv tail and the xLSTM states, which
    have no sequence, take rows only where the data axes divide the
    batch, else stay whole (the reference's constraint would split their
    second axis inside its step, a layout of that step's state, not of
    the stored cache)."""
    from repro_torch.sharding import make_policy

    policy = make_policy(mesh, batch_size,
                         shard_seq=_splits_sequence(cfg, mesh, batch_size, max_len))
    return policy.shardings(cache_specs(cfg), _cache_tree(cfg, batch_size, max_len, _Leaf))


def _data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != "model")


def batch_rows(mesh, batch_size: int) -> tuple[int, int]:
    """(first row, rows) of a batch of ``batch_size`` that a rank of
    ``mesh`` holds on blocks: its share over the data axes (every axis but
    ``model``, row-major) where they divide the batch, else every row."""
    dp = _data_axes(mesh)
    n = mesh.size(dp)
    if batch_size % n:
        return 0, batch_size
    return mesh.index(dp) * (batch_size // n), batch_size // n


def _splits_sequence(cfg, mesh, batch_size: int, max_len: int) -> bool:
    """Whether a rank of ``mesh`` holds only its block of the k / v cache's
    sequence: a family of ``shards_storage`` with a k / v cache, whose
    batch the data axes do not divide while they divide ``max_len``."""
    if cfg.block_type == "xlstm" or not shards_storage(cfg, mesh):
        return False
    n = mesh.size(_data_axes(mesh))
    return n > 1 and batch_size % n != 0 and max_len % n == 0


def seq_block(cfg, mesh, batch_size: int, max_len: int) -> tuple[int, int]:
    """(first position, positions) of the k / v cache of ``max_len``
    positions that a rank of ``mesh`` holds for a batch of ``batch_size``:
    its block over the data axes (row-major, as ``batch_rows``) where they
    do not divide the batch but divide ``max_len``, else every position."""
    if not _splits_sequence(cfg, mesh, batch_size, max_len):
        return 0, max_len
    dp = _data_axes(mesh)
    n = max_len // mesh.size(dp)
    return mesh.index(dp) * n, n


def _whole_len(cfg, mesh, batch_size: int, held: int) -> int:
    """The whole cache's length, from the ``held`` positions of a rank's
    k / v block: ``held`` times the data axes' size where the batch does
    not divide over them and ``held`` does (a whole cache of ``held``
    positions would have been split), ``held`` where they divide the batch
    or there is one data rank.  Raises where the two readings stay open."""
    n = mesh.size(_data_axes(mesh))
    if cfg.block_type == "xlstm" or n == 1 or batch_size % n == 0:
        return held
    if held % n == 0:
        return held * n
    raise ValueError(f"a cache block of {held} positions for a batch of {batch_size} on "
                     f"{mesh.shape} is a whole cache of {held} or a block of {held * n}: "
                     f"pass max_len")


def _logits_blocks(params, cfg, h, mesh, batch_size: int):
    """The logits (B, V) of the rank's rows' last hidden states ``h`` on
    its blocks, replicated as the reference's step returns them: the
    vocab-parallel head's blocks gathered over ``model``, the rows over the
    data axes where they split the batch."""
    logits = _logits(params, cfg, h)
    if logits.shape[-1] != cfg.vocab:
        logits = mesh.all_gather(logits, "model", dim=-1)
    if logits.shape[0] != batch_size:
        logits = mesh.all_gather(logits, _data_axes(mesh))
    return logits


# the dimension along which a rank's recurrent cache entries hold only its
# channels or heads where the cache holds them whole over model
_MODEL_DIM = {"ssm_h": 1, "conv": 2, "mlstm": 1, "slstm": 1}


@torch.no_grad()
def prefill(params, cfg, batch: dict, max_len: int, mesh=None, batch_size: int | None = None):
    """Run the prompt ``batch`` (``embed_inputs``'s dict; a "labels" entry
    is ignored) through the parameter tree -> (the last position's logits
    (B, V), the cache with the prompt's entries at positions [0, S), room
    up to ``max_len``).  S is the embedded sequence's length: for vlm the
    patches and the tokens.

    On a grid, for the families of ``shards_storage``: ``params`` are
    this rank's blocks and ``batch`` its rows (``batch_rows``: every row
    where the data axes do not divide the batch) of a batch of
    ``batch_size`` (by default its rows times the data axes' size: a batch
    they split); the prompt runs tensor-parallel (``forward(...,
    tp=mesh)``), the cache is the rank's block (``init_cache(...,
    mesh=)``), the recurrent states gathered over ``model`` where it holds
    them whole, and the logits come out replicated (``_logits_blocks``).
    Where the data axes split the cache's sequence (``seq_block``: a batch
    they do not divide, a ``max_len`` they do), every data rank runs every
    row of the prompt and keeps the prompt's k and v at the positions of
    its block, none where its block starts at or past S.  An MoE layer
    takes ``_moe_blocks``' rule for the prompt's tokens, MLA its rank's
    heads."""
    sharded = shards_storage(cfg, mesh)
    tp = mesh if sharded else None
    x, _ = embed_inputs(params, cfg, batch, tp=tp)
    b, s = x.shape[:2]
    if s > max_len:
        raise ValueError(f"a prompt of {s} positions does not fit a cache of {max_len}")
    first, held = 0, max_len
    if sharded:
        batch_size = batch_size or b * mesh.size(_data_axes(mesh))
        if batch_rows(mesh, batch_size)[1] != b:
            raise ValueError(f"a rank holds {batch_rows(mesh, batch_size)[1]} rows of a batch "
                             f"of {batch_size} on {mesh.shape}; got {b}")
        h, caches = forward(params, cfg, x, collect_cache=True, mesh=mesh, tp=mesh,
                            whole_rows=batch_size % mesh.size(_data_axes(mesh)) != 0)
        logits = _logits_blocks(params, cfg, h[:, -1], mesh, batch_size)
        cache = init_cache(cfg, batch_size, max_len, device=h.device, mesh=mesh)
        first, held = seq_block(cfg, mesh, batch_size, max_len)
    else:
        h, caches = forward(params, cfg, x, collect_cache=True, mesh=mesh)
        logits = _logits(params, cfg, h[:, -1])
        cache = init_cache(cfg, b, max_len, device=h.device)
    lo, hi = first, min(first + held, s)     # the prompt's positions in the block
    for i, entries in enumerate(caches):
        for name, value in entries.items():
            if name in ("k", "v", "latent", "k_rope"):
                if hi > lo:
                    cache[name][i, :, :hi - lo] = value[:, lo:hi]
                continue
            dst = cache[name] if isinstance(cache[name], tuple) else (cache[name],)
            src = value if isinstance(value, tuple) else (value,)
            dim = _MODEL_DIM[name]
            for whole, part in zip(dst, src):
                if sharded and part.shape[dim] != whole.shape[dim + 1]:
                    part = mesh.all_gather(part, "model", dim=dim)
                whole[i] = part
    return logits, cache


def _apply_layer_decode(pl, cfg, x, flags: dict[str, float], tabs_l, tabs_g, cache: dict,
                        i: int, pos: int, mesh=None, tp=None, seq=None, whole_rows=False):
    """One layer, one token; layer ``i``'s cache entries advance in place.
    ``tp``: on a rank's blocks and its cache block; ``seq``: the first
    position of that block where it holds a block of the sequence;
    ``whole_rows``: x holds every row (``_moe_blocks``)."""
    if cfg.block_type == "xlstm":
        name = "mlstm" if flags["is_mlstm"] > 0 else "slstm"
        state = tuple(t[i] for t in cache[name])
        out, new = getattr(ssm_mod, f"{name}_decode")(pl["xlstm"], cfg,
                                                      _norm(pl, cfg, x, "norm1"), state, tp=tp)
        for dst, src in zip(state, new):
            dst.copy_(src)
        return x + out
    is_global = flags["is_global"]
    sin, cos = _select_rope(tabs_l, tabs_g, is_global)
    h = _norm(pl, cfg, x, "norm1")
    if cfg.use_mla:
        a_out, _ = mla_decode(pl["attn"], cfg, h, sin, cos,
                              (cache["latent"][i], cache["k_rope"][i]), pos, is_global, tp=tp,
                              seq=seq)
    else:
        a_out, _ = gqa_decode(pl["attn"], cfg, h, sin, cos, (cache["k"][i], cache["v"][i]),
                              pos, is_global, tp=tp, seq=seq)
    if cfg.block_type == "hymba":
        s_out, (cache["ssm_h"][i], cache["conv"][i]) = ssm_mod.mamba_decode(
            pl["ssm"], cfg, h, cache["ssm_h"][i], cache["conv"][i], tp=tp)
        a_out = _hymba_fuse(pl, cfg, a_out, s_out)
    x = x + a_out
    # decode drops the aux
    return x + _ffn(pl["mlp"], cfg, _norm(pl, cfg, x, "norm2"), mesh, tp, whole_rows)[0]


@torch.no_grad()
def decode_step(params, cfg, batch: dict, cache: dict, pos: int, mesh=None,
                max_len: int | None = None):
    """One greedy-decode step: ``batch["token"]`` (B, 1) (a frames model:
    ``batch["frame"]`` (B, 1, d), RMS-normed as the prompt's frames) at
    position ``pos`` -> (logits (B, V), cache), the cache advanced in
    place.

    On a grid, for the families of ``shards_storage``: ``params`` and
    ``cache`` are this rank's blocks (``init_cache(..., mesh=)``); the
    batch is every row, as the reference's step takes it replicated, and
    the rank steps the cache block's rows: the vocab-parallel lookup, GQA
    on its q and kv heads (``gqa_decode(..., tp=)``), the Mamba heads on
    its channels and the xLSTM cores on its heads (their states, whole over
    ``model``, brought back whole each step), the MLP's blocks; the logits
    come out replicated (``_logits_blocks``).  Where the cache block holds
    the rank's block of the sequence (``seq_block``), GQA writes the token
    only on the rank whose block holds ``pos`` and combines the blocks'
    partial softmaxes over the data axes; ``max_len`` is the whole cache's
    length, by default read from the block (``_whole_len``, which raises
    where a block and a whole cache cannot be told apart).  MLA attends its
    rank's heads to the latent block the same way (``mla_decode(...,
    tp=, seq=)``), an MoE layer takes ``_moe_blocks``' rule for the
    batch's tokens."""
    sharded = shards_storage(cfg, mesh)
    tp = mesh if sharded else None
    rows = batch["frame" if cfg.input_mode == "frames" else "token"]
    batch_size = rows.shape[0]
    if sharded:
        lo, n = batch_rows(mesh, batch_size)
        rows = rows[lo:lo + n]
    if cfg.input_mode == "frames":
        x = _embed_frames(params, cfg, rows)
    else:
        x = _embed_tokens(params, cfg, rows, tp)
    pos = int(pos)
    tabs_l = tabs_g = seq = None
    if cfg.block_type != "xlstm":
        held = cache["latent" if cfg.use_mla else "k"].shape[2]
        if sharded:
            max_len = max_len or _whole_len(cfg, mesh, batch_size, held)
            first, n = seq_block(cfg, mesh, batch_size, max_len)
            if n != held:
                raise ValueError(f"a rank holds {n} positions of a cache of {max_len} for a "
                                 f"batch of {batch_size} on {mesh.shape}; got {held}")
            seq = first if n != max_len else None
        else:
            max_len = held
        tabs_l, tabs_g = _rope_tables(cfg, max_len, x.device, positions=pos)
    flags = layer_flags(cfg)
    whole_rows = sharded and batch_size % mesh.size(_data_axes(mesh)) != 0
    for i, pl in enumerate(params["layers"]):
        x = _apply_layer_decode(pl, cfg, x, _flags_at(flags, i), tabs_l, tabs_g, cache,
                                i, pos, mesh, tp=tp, seq=seq, whole_rows=whole_rows)
    x = _norm(params, cfg, x, "final_norm")
    if sharded:
        return _logits_blocks(params, cfg, x[:, 0], mesh, batch_size), cache
    return _logits(params, cfg, x[:, 0]), cache
