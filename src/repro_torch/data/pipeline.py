"""Minimal batching pipeline, ported from ``repro.data.pipeline``: a
shuffled host-side numpy minibatch iterator for centralized and example
paths (federated rounds draw their minibatches through the engine's
``draws``)."""

from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["batch_iterator"]


def batch_iterator(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    seed: int = 0,
    drop_remainder: bool = True,
    epochs: int | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Shuffled minibatch iterator; loops ``epochs`` times (None = forever).
    One ``np.random.default_rng(seed).permutation`` an epoch, as the
    reference draws it."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    epoch = 0
    while epochs is None or epoch < epochs:
        perm = rng.permutation(n)
        end = n - (n % batch_size) if drop_remainder else n
        for s in range(0, end, batch_size):
            ix = perm[s : s + batch_size]
            yield x[ix], y[ix]
        epoch += 1
