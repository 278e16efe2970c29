"""Hellinger distance over label histograms (FedLECC §IV-A), in PyTorch.

The Hellinger distance between two discrete distributions p, q over C
classes is

    HD(p, q) = sqrt(1 - sum_c sqrt(p_c * q_c))            (bounded in [0, 1])

The Bhattacharyya coefficient sum_c sqrt(p_c q_c) is an inner product of
sqrt-histograms.  ``hellinger_matrix`` / ``average_hd`` build the dense
K x K matrix with one fp32 matrix product on the input's device (numpy
inputs run on the CPU, as the partition calibration does).
``hellinger_blocked`` assembles the same matrix from (block, K) strips,
each computed by the Hellinger strip kernel when the panel lies on CUDA
(``repro_torch.kernels.hellinger``, plain PyTorch on the CPU), so device
memory stays O(K·block); on the card the strips leave through two pinned
staging buffers on a copy stream, double-buffered, so a strip's copy to
the host overlaps the next strip's kernel and the previous strip's move
into the output.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.hellinger import hellinger_strip

__all__ = [
    "hellinger_distance",
    "hellinger_matrix",
    "hellinger_rows",
    "hellinger_blocked",
    "average_hd",
    "dense_budget_bytes",
    "set_dense_budget_bytes",
]


def _as_f32(x) -> torch.Tensor:
    """fp32 tensor on the input's device (numpy and lists go to the CPU)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))


def _normalize(h: torch.Tensor) -> torch.Tensor:
    return h / torch.clamp(h.sum(-1, keepdim=True), min=1e-12)


def hellinger_distance(p, q) -> torch.Tensor:
    """HD between two histograms (unnormalized inputs are normalized)."""
    p, q = _normalize(_as_f32(p)), _normalize(_as_f32(q))
    bc = torch.sqrt(p * q).sum(-1)
    return torch.sqrt(torch.clamp(1.0 - bc, 0.0, 1.0))


def hellinger_matrix(hists) -> torch.Tensor:
    """(K, C) histograms (rows normalized internally) -> (K, K) float32
    symmetric distance matrix with an exactly zero diagonal."""
    r = torch.sqrt(_normalize(_as_f32(hists)))
    d = torch.sqrt(torch.clamp(1.0 - r @ r.T, 0.0, 1.0))
    return d * (1.0 - torch.eye(r.shape[0], dtype=d.dtype, device=d.device))


# Memory guard: consumers that materialize the dense K x K float32 matrix
# (host-side) warn past this budget so a population-scale K does not
# silently eat the server's RAM.  Configurable because benchmarks probe
# above it deliberately.
_DENSE_BUDGET_BYTES = 1 << 30  # 1 GiB ≈ K = 16384


def dense_budget_bytes() -> int:
    """The current dense-matrix warning budget in bytes."""
    return _DENSE_BUDGET_BYTES


def set_dense_budget_bytes(n_bytes: int) -> int:
    """Set the dense-matrix warning budget; returns the previous value."""
    global _DENSE_BUDGET_BYTES
    if int(n_bytes) < 1:
        raise ValueError(f"dense budget must be >= 1 byte, got {n_bytes}")
    old = _DENSE_BUDGET_BYTES
    _DENSE_BUDGET_BYTES = int(n_bytes)
    return old


def _warn_if_over_budget(k: int, budget_bytes: int | None) -> None:
    budget = _DENSE_BUDGET_BYTES if budget_bytes is None else int(budget_bytes)
    need = k * k * 4
    if need > budget:
        warnings.warn(
            f"dense {k}x{k} Hellinger matrix needs {need / 2**20:.0f} MiB "
            f"(budget {budget / 2**20:.0f} MiB) — at this population scale "
            f"prefer shard-level clustering or raise the budget via "
            f"repro_torch.core.hellinger.set_dense_budget_bytes",
            ResourceWarning,
            stacklevel=3,
        )


def _sqrt_rows(hists) -> np.ndarray:
    h = np.asarray(hists, np.float32)
    h = h / np.maximum(h.sum(axis=-1, keepdims=True), 1e-12)
    return np.sqrt(h)


def hellinger_rows(rows, hists, *, device: str | torch.device = "cuda") -> np.ndarray:
    """(B, C) query histograms against (K, C) histograms -> (B, K) float32
    host strip (no diagonal treatment), computed on ``device``."""
    dev = resolve_device(device)
    rb = torch.from_numpy(_sqrt_rows(np.atleast_2d(rows))).to(dev)
    r = torch.from_numpy(_sqrt_rows(hists)).to(dev)
    return hellinger_strip(rb, r).cpu().numpy()


def hellinger_blocked(
    hists,
    block: int = 4096,
    *,
    device: str | torch.device = "cuda",
    budget_bytes: int | None = None,
) -> np.ndarray:
    """Pairwise K x K Hellinger matrix assembled from (block, K) strips.

    The sqrt-histogram panel goes to ``device`` once; each strip is one
    Hellinger strip kernel launch there (the plain version on the CPU),
    so peak device memory is O(K·block).  On the card each strip leaves
    through a pinned staging buffer (``_copy_out_pinned``); on the CPU it
    is copied straight into the output.  Every entry is its strip
    element's bits, whatever ``block``.  The K x K float32 host result
    still gets allocated; past the dense budget
    (``set_dense_budget_bytes``) a ``ResourceWarning`` says so."""
    h = np.atleast_2d(np.asarray(hists, np.float32))
    k = h.shape[0]
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    dev = resolve_device(device)
    _warn_if_over_budget(k, budget_bytes)
    r = torch.from_numpy(_sqrt_rows(h)).to(dev)
    out = np.empty((k, k), np.float32)
    strips = [(i0, min(i0 + block, k)) for i0 in range(0, k, block)]
    if dev.type == "cuda":
        _copy_out_pinned(r, strips, out)
    else:
        host = torch.from_numpy(out)
        for i0, i1 in strips:
            host[i0:i1].copy_(hellinger_strip(r[i0:i1], r))
    np.fill_diagonal(out, 0.0)
    return out


def _copy_out_pinned(r: torch.Tensor, strips: list[tuple[int, int]], out: np.ndarray) -> None:
    """The strips of ``r`` (on CUDA) into ``out`` through two pinned
    (block, K) staging buffers: strip i's kernel runs on the current
    stream, its copy into buffer i % 2 on a copy stream that waits for it,
    and the host then moves strip i - 1 out of the other buffer while
    strip i's copy (and strip i + 1's kernel) run.  A buffer is refilled
    only after the host has moved its last strip out."""
    k = r.shape[0]
    rows = max(i1 - i0 for i0, i1 in strips)
    n_buf = min(2, len(strips))
    stage = [torch.empty((rows, k), dtype=torch.float32, pin_memory=True) for _ in range(n_buf)]
    host = torch.from_numpy(out)
    compute = torch.cuda.current_stream(r.device)
    copy = torch.cuda.Stream(r.device)
    done: list[torch.cuda.Event | None] = [None] * n_buf

    def move_out(i: int) -> None:
        i0, i1 = strips[i]
        done[i % n_buf].synchronize()
        host[i0:i1].copy_(stage[i % n_buf][: i1 - i0])

    for i, (i0, i1) in enumerate(strips):
        strip = hellinger_strip(r[i0:i1], r)
        copy.wait_stream(compute)
        with torch.cuda.stream(copy):
            stage[i % n_buf][: i1 - i0].copy_(strip, non_blocking=True)
            done[i % n_buf] = torch.cuda.Event()
            done[i % n_buf].record(copy)
        strip.record_stream(copy)
        if i > 0:
            move_out(i - 1)
    move_out(len(strips) - 1)


def average_hd(hists) -> torch.Tensor:
    """Mean off-diagonal HD — the paper's scalar "how non-IID" measure,
    which the partitioner calibrates against (0-dim fp32 tensor)."""
    d = hellinger_matrix(hists)
    k = d.shape[0]
    return d.sum() / max(k * (k - 1), 1)
