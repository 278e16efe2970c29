"""Synthetic data (numpy), a copy of ``repro.data.synthetic``.

``make_classification`` builds a class-conditional Gaussian mixture in
pixel space: each class owns a small number of prototype "digits"
(smooth random blobs), samples are prototype + pixel noise, clipped to
[0, 1].  ``make_token_stream`` draws order-2 Markov token sequences for
the LM task.  The same arguments give bit-identical arrays to the
reference, so both packages partition and train on the same data.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["Dataset", "make_classification", "make_token_stream"]


class Dataset(NamedTuple):
    x: np.ndarray  # (N, F) float32 features  /  (N, S) int32 tokens
    y: np.ndarray  # (N,)  int64 labels       /  (N, S) int32 next-tokens


def _smooth_prototype(rng: np.random.Generator, side: int) -> np.ndarray:
    """Random smooth blob image: low-frequency noise, normalized to [0,1]."""
    coarse = rng.normal(size=(side // 4, side // 4))
    img = np.kron(coarse, np.ones((4, 4)))  # upsample
    # cheap blur
    for _ in range(2):
        img = (
            img
            + np.roll(img, 1, 0)
            + np.roll(img, -1, 0)
            + np.roll(img, 1, 1)
            + np.roll(img, -1, 1)
        ) / 5.0
    img = img - img.min()
    return (img / max(img.max(), 1e-9)).astype(np.float32)


def make_classification(
    n: int,
    n_features: int = 784,
    n_classes: int = 10,
    prototypes_per_class: int = 2,
    noise: float = 0.25,
    seed: int = 0,
    proto_seed: int = 1234,
) -> Dataset:
    """Class-conditional Gaussian-mixture images, MNIST-like scale.

    ``proto_seed`` fixes the class prototypes (the task); ``seed`` draws
    the samples.  Train/test splits share ``proto_seed`` and differ in
    ``seed`` — otherwise they would be two unrelated tasks.
    """
    proto_rng = np.random.default_rng(proto_seed)
    rng = np.random.default_rng(seed)
    side = int(round(n_features**0.5))
    assert side * side == n_features, "n_features must be a square"
    protos = np.stack(
        [
            np.stack(
                [_smooth_prototype(proto_rng, side).ravel() for _ in range(prototypes_per_class)]
            )
            for _ in range(n_classes)
        ]
    )  # (C, P, F)
    y = rng.integers(0, n_classes, size=n).astype(np.int64)
    which = rng.integers(0, prototypes_per_class, size=n)
    x = protos[y, which] + rng.normal(0.0, noise, size=(n, n_features)).astype(np.float32)
    x = np.clip(x, 0.0, 1.0).astype(np.float32)
    return Dataset(x=x, y=y)


def make_token_stream(
    n_seqs: int,
    seq_len: int,
    vocab: int,
    seed: int = 0,
    order: int = 2,
) -> Dataset:
    """Order-``order`` Markov chain token sequences (learnable structure)."""
    rng = np.random.default_rng(seed)
    # Sparse transition table: each context maps to a few likely tokens.
    # Favored tokens are drawn with a power-law skew so the stream has a
    # non-uniform unigram distribution too — models show loss progress
    # within hundreds of steps instead of needing to crack the full
    # order-2 structure first.
    n_ctx = min(vocab**order, 65536)
    fav = np.floor(vocab * rng.random((n_ctx, 4)) ** 3).astype(np.int64)
    toks = np.empty((n_seqs, seq_len + 1), dtype=np.int32)
    toks[:, :order] = rng.integers(0, vocab, size=(n_seqs, order))
    ctx = (toks[:, 0] * 31 + toks[:, 1] * 7) % n_ctx if order == 2 else toks[:, 0] % n_ctx
    for t in range(order, seq_len + 1):
        pick = rng.integers(0, 4, size=n_seqs)
        explore = rng.random(n_seqs) < 0.1
        nxt = np.where(explore, rng.integers(0, vocab, size=n_seqs), fav[ctx, pick])
        toks[:, t] = nxt
        ctx = (ctx * 31 + nxt * 7) % n_ctx
    return Dataset(x=toks[:, :-1].astype(np.int32), y=toks[:, 1:].astype(np.int32))
