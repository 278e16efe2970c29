"""Wrapper of the Hellinger strip kernel (``csrc/hellinger_strip.cu``).

The port's counterpart of ``hellinger_strip_pallas``: inputs arrive
normalized and square-rooted, with no padding (the kernel masks the ragged
edges itself) and no diagonal fix (the caller assembling a square matrix
owns its diagonal).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.hellinger.ref import hellinger_strip_ref

__all__ = ["hellinger_strip"]

_TILE = 32           # output tile edge in the kernel
_MAX_GRID_Y = 65535  # CUDA's limit on gridDim.y, which counts row tiles


@functools.cache
def _kernel():
    fn = load("hellinger_strip").hellinger_strip_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(rb: torch.Tensor, r: torch.Tensor) -> None:
    if rb.device != r.device or rb.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"panels must share one CPU or CUDA device; got {rb.device} and {r.device}"
        )
    if rb.dtype != torch.float32 or r.dtype != torch.float32:
        raise TypeError(f"panels must be float32; got {rb.dtype} and {r.dtype}")
    if rb.ndim != 2 or r.ndim != 2 or rb.shape[1] != r.shape[1]:
        raise ValueError(
            f"panels must be (B, C) and (K, C); got {tuple(rb.shape)} and {tuple(r.shape)}"
        )
    if not (rb.is_contiguous() and r.is_contiguous()):
        raise ValueError("panels must be contiguous")
    b, k = rb.shape[0], r.shape[0]
    if k >= 2**31 or rb.shape[1] >= 2**31 or -(-b // _TILE) > _MAX_GRID_Y:
        raise ValueError(f"strip ({b}, {k}, C={rb.shape[1]}) exceeds the kernel's grid")


def hellinger_strip(rb: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(B, C) x (K, C) fp32 sqrt-histogram panels -> (B, K) fp32 strip
    HD = sqrt(clip(1 - rb @ r.T, 0, 1)).

    CUDA tensors launch the kernel on the current stream (counted in
    ``hellinger_strip.launches``); CPU tensors take the plain version."""
    _check(rb, r)
    if rb.device.type == "cpu":
        return hellinger_strip_ref(rb, r)
    b, c = rb.shape
    k = r.shape[0]
    out = torch.empty((b, k), dtype=torch.float32, device=rb.device)
    if b == 0 or k == 0:
        return out
    err = _kernel()(rb.data_ptr(), r.data_ptr(), out.data_ptr(), b, k, c,
                    rb.device.index, torch.cuda.current_stream(rb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hellinger_strip kernel launch failed: cudaError {err}")
    hellinger_strip.launches += 1
    return out


hellinger_strip.launches = 0  # type: ignore[attr-defined]
