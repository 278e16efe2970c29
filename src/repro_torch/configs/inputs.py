"""Input construction, ported from ``repro.configs.inputs``:
``dummy_batch`` and ``dummy_decode_batch`` draw the same numbers as the
reference from the same numpy seed, in the same order (the frames or
patches, then the tokens, then the labels), as CPU tensors (the caller
moves them to its device): tokens and labels int32, frames and patches
in ``cfg.dtype``, rounded from the float64 normals through float32 as the
reference's ``jnp.asarray`` rounds them.

``input_specs`` and ``decode_specs`` are the shapes and types of a batch
at one of ``INPUT_SHAPES`` without its data: tensors on the ``meta``
device, the port's counterpart of the reference's ``ShapeDtypeStruct``s
(frames and patches bf16, tokens and labels int32, as the reference's).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

__all__ = ["input_specs", "dummy_batch", "decode_specs", "dummy_decode_batch",
           "long_context_variant"]


def _f(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape | str) -> dict[str, torch.Tensor]:
    """A full-sequence batch (train or prefill) as ``meta`` tensors:
    {"tokens"} (B, S), {"frames"} (B, S, d), or {"patches"} (B, n_patches,
    d) and {"tokens"} (B, S - n_patches); "labels" (B, S) for a train
    shape.  Decode shapes take ``decode_specs``."""
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    b, s = shape.global_batch, shape.seq_len
    if cfg.input_mode == "tokens":
        batch = {"tokens": _f((b, s), torch.int32)}
    elif cfg.input_mode == "frames":
        batch = {"frames": _f((b, s, cfg.d_model), torch.bfloat16)}
    else:
        p = cfg.n_patches
        batch = {"patches": _f((b, p, cfg.d_model), torch.bfloat16),
                 "tokens": _f((b, s - p), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = _f((b, s), torch.int32)
    return batch


def decode_specs(cfg: ModelConfig, shape: InputShape | str) -> dict[str, torch.Tensor]:
    """The one-token decode step's input as ``meta`` tensors: {"frame"}
    (B, 1, d) for frame models, else {"token"} (B, 1)."""
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    b = shape.global_batch
    if cfg.input_mode == "frames":
        return {"frame": _f((b, 1, cfg.d_model), torch.bfloat16)}
    return {"token": _f((b, 1), torch.int32)}


def _normal(rng: np.random.Generator, shape, cfg: ModelConfig) -> torch.Tensor:
    """N(0, 1) draws in ``cfg.dtype``: float64 -> float32 -> the dtype."""
    x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    return x.to(getattr(torch, cfg.dtype))


def _ints(rng: np.random.Generator, high: int, shape) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, high, shape).astype(np.int32))


def dummy_batch(cfg: ModelConfig, batch_size: int, seq_len: int,
                seed: int = 0) -> dict[str, torch.Tensor]:
    """A random batch drawn as the reference draws it from
    ``np.random.default_rng(seed)``: {"tokens"} (B, S) for token models,
    {"frames"} (B, S, d) for frame models, {"patches"} (B, n_patches, d)
    and {"tokens"} (B, S - n_patches) for vlm models; always "labels"
    (B, S)."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        batch = {"tokens": _ints(rng, cfg.vocab, (batch_size, seq_len))}
    elif cfg.input_mode == "frames":
        batch = {"frames": _normal(rng, (batch_size, seq_len, cfg.d_model), cfg)}
    elif cfg.input_mode == "vlm":
        p = cfg.n_patches
        batch = {"patches": _normal(rng, (batch_size, p, cfg.d_model), cfg),
                 "tokens": _ints(rng, cfg.vocab, (batch_size, seq_len - p))}
    else:
        raise ValueError(f"unknown input_mode {cfg.input_mode!r}")
    batch["labels"] = _ints(rng, cfg.vocab, (batch_size, seq_len))
    return batch


def dummy_decode_batch(cfg: ModelConfig, batch_size: int,
                       seed: int = 0) -> dict[str, torch.Tensor]:
    """One random input a sequence, as the reference draws it: {"frame":
    (B, 1, d)} in ``cfg.dtype`` for frame models, else {"token": (B, 1)
    int32}."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "frames":
        return {"frame": _normal(rng, (batch_size, 1, cfg.d_model), cfg)}
    return {"token": _ints(rng, cfg.vocab, (batch_size, 1))}


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """The reference's sliding-window variant for very long contexts:
    hybrid and recurrent models and those with a native local/global
    pattern are returned unchanged; every other model gets a 4096-token
    window on all layers."""
    native_subquadratic = (
        cfg.block_type in ("xlstm", "hymba") or (cfg.sliding_window and "L" in cfg.layer_pattern)
    )
    if native_subquadratic:
        return cfg
    return replace(cfg, name=cfg.name + "+swa4k", sliding_window=4096, layer_pattern="L")
