"""Wrapper of the FedAvg reduce kernel (``csrc/fedavg_reduce.cu``).

The port's counterpart of ``masked_weighted_sum_pallas``: one launch
reduces a whole (M, N) cohort of flat parameter vectors, with no padding
of N.  ``load_width`` picks the columns a thread (the width of its
loads) from the cohort's address and row pitch.

The launch makes no synchronising call, so it can be captured into a
CUDA graph (``repro_torch.engine.fused``).  A captured launch runs at
each replay, not when the wrapper is called: the wrapper counts it in
``masked_weighted_sum.captured`` instead of ``.launches``, and whoever
replays the graph counts the replays.  The graph keeps the address (and
so the load width) of the cohort seen at capture; its replays reuse that
buffer.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.aggregate.ref import masked_weighted_sum_ref
from repro_torch.kernels.build import Work, count_launch, kernel_path, load, tally_kernel

__all__ = ["load_width", "masked_weighted_sum", "reduce_work"]

_SYMBOLS = {torch.float32: "fedavg_reduce_f32", torch.bfloat16: "fedavg_reduce_bf16"}
_THREADS = 256           # threads a block in the kernel
_MAX_BLOCKS = 2**31 - 1  # CUDA's limit on gridDim.x


def load_width(addr: int, n: int, elt: int, sms: int = 132) -> int:
    """Columns a thread of the kernel for an (M, N) cohort of ``elt``-byte
    elements at device address ``addr`` on a card with ``sms`` SMs.  A
    thread loads its columns as one vector a row: the widest of 16, 8 or 4
    bytes that divides both ``addr`` and the row pitch N * ``elt`` (so
    every row's vectors are aligned and N is a multiple of the width) and
    still leaves two 256-thread blocks an SM; one column where no width
    does."""
    for width in (16, 8, 4):
        vec = width // elt
        if addr % width or (n * elt) % width:
            continue
        if -(-n // vec // _THREADS) >= 2 * sms:
            return vec
    return 1


def reduce_work(m: int, n: int, elem: int) -> Work:
    """One call's ``Work`` at an (M, N) cohort of ``elem``-byte elements:
    no product (the reference sums w_m x_m elementwise, then over the pod
    axis), 2 M N flops, the cohort, the weights and the fp32 output once."""
    return Work(0.0, 2.0 * m * n, float(m * n * elem + 4 * m + 4 * n))


@functools.cache
def _kernel(dtype: torch.dtype):
    fn = getattr(load("fedavg_reduce"), _SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(stacked: torch.Tensor, weights: torch.Tensor) -> None:
    if stacked.device != weights.device or stacked.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(
            f"stacked and weights must share one CPU, CUDA or meta device; got "
            f"{stacked.device} and {weights.device}"
        )
    if stacked.dtype not in _SYMBOLS:
        raise TypeError(f"stacked must be float32 or bfloat16; got {stacked.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32; got {weights.dtype}")
    if stacked.ndim != 2 or weights.shape != (stacked.shape[0],):
        raise ValueError(
            f"stacked must be (M, N) and weights (M,); got {tuple(stacked.shape)} "
            f"and {tuple(weights.shape)}"
        )
    if not (stacked.is_contiguous() and weights.is_contiguous()):
        raise ValueError("stacked and weights must be contiguous")
    if stacked.shape[0] >= 2**31 or -(-stacked.shape[1] // _THREADS) > _MAX_BLOCKS:
        raise ValueError(f"cohort {tuple(stacked.shape)} exceeds the kernel's grid")


def masked_weighted_sum(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(M, N) fp32/bf16 stacked replicas x (M,) fp32 weights -> (N,) fp32
    sum_m w_m * x_m, accumulated in fp32.

    CUDA tensors launch the kernel on the current stream (counted in
    ``masked_weighted_sum.launches``, or ``.captured`` while the stream is
    being captured into a CUDA graph); ``meta`` tensors the same path
    without the launch; CPU tensors take the plain version."""
    _check(stacked, weights)
    path = kernel_path(stacked)
    if path == "plain":
        return masked_weighted_sum_ref(stacked, weights)
    m, n = stacked.shape
    out = torch.empty(n, dtype=torch.float32, device=stacked.device)
    if n == 0:
        return out
    tally_kernel("masked_weighted_sum", reduce_work(m, n, stacked.element_size()))
    if path == "meta":
        return out
    index = stacked.device.index
    vec = load_width(stacked.data_ptr(), n, stacked.element_size(), _sms(index))
    err = _kernel(stacked.dtype)(
        stacked.data_ptr(), weights.data_ptr(), out.data_ptr(), m, n, vec, index,
        torch.cuda.current_stream(stacked.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"masked_weighted_sum kernel launch failed: cudaError {err}")
    count_launch(masked_weighted_sum)
    return out


masked_weighted_sum.launches = 0  # type: ignore[attr-defined]
masked_weighted_sum.captured = 0  # type: ignore[attr-defined]
