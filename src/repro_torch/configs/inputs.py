"""Input construction, ported from ``repro.configs.inputs`` for token
inputs: ``dummy_batch`` and ``dummy_decode_batch`` draw the same numbers
as the reference from the same numpy seed, as int32 CPU tensors (the
caller moves them to its device).

Not ported (``UNPORTED`` says why): the reference's ``ShapeDtypeStruct``
specs for its dry runs (``input_specs``, ``decode_specs``), which are
jax objects, and frame and image-patch inputs (musicgen-large,
internvl2-1b), whose models the port does not register yet.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["dummy_batch", "dummy_decode_batch", "long_context_variant"]

UNPORTED = {
    "input_specs": "jax ShapeDtypeStruct specs for the reference's dry runs",
    "decode_specs": "jax ShapeDtypeStruct specs for the reference's dry runs",
    "frames": "frame inputs (musicgen-large): no such model in the port yet",
    "vlm": "image-patch inputs (internvl2-1b): no such model in the port yet",
}


def _tokens_only(cfg: ModelConfig) -> None:
    if cfg.input_mode != "tokens":
        raise ValueError(f"repro_torch builds token inputs only; {cfg.name!r} has "
                         f"input_mode={cfg.input_mode!r} ({UNPORTED.get(cfg.input_mode)})")


def dummy_batch(cfg: ModelConfig, batch_size: int, seq_len: int,
                seed: int = 0) -> dict[str, torch.Tensor]:
    """A random token batch {"tokens", "labels"} (B, S) int32, drawn as the
    reference draws it from ``np.random.default_rng(seed)``."""
    _tokens_only(cfg)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch_size, seq_len))
    labels = rng.integers(0, cfg.vocab, (batch_size, seq_len))
    return {"tokens": torch.from_numpy(tokens.astype(np.int32)),
            "labels": torch.from_numpy(labels.astype(np.int32))}


def dummy_decode_batch(cfg: ModelConfig, batch_size: int,
                       seed: int = 0) -> dict[str, torch.Tensor]:
    """One random token a sequence, {"token": (B, 1) int32}, as the
    reference draws it."""
    _tokens_only(cfg)
    rng = np.random.default_rng(seed)
    return {"token": torch.from_numpy(rng.integers(0, cfg.vocab, (batch_size, 1))
                                      .astype(np.int32))}


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
