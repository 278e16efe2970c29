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

__all__ = ["hellinger_strip", "tile_choice"]

_TILE_ROWS, _TILE_COLS = 64, 128  # a block's output tile at 8 rows a thread; 4 halve the rows
_MAX_GRID_Y = 65535               # CUDA's limit on gridDim.y, which counts row tiles


def tile_choice(b: int, k: int, out_addr: int, sms: int = 132) -> tuple[bool, int]:
    """(16-byte stores, tile rows a thread) of the kernel for a (``b``,
    ``k``) strip written at device address ``out_addr`` on a card with
    ``sms`` SMs.  A tile row leaves in 16-byte stores when every strip row
    starts 16-byte aligned (K % 4 == 0 and an aligned ``out``), else in
    masked 4-byte stores.  A thread owns 8 rows (64 x 128 tiles) where
    the strip has at least one such tile an SM, else 4 (32 x 128), so that
    a small strip spreads over more SMs.  The panels' alignment does not
    enter: the kernel stages them with 4-byte loads, so a row slice such as
    ``r[7:300]`` takes either path."""
    vec_store = k % 4 == 0 and out_addr % 16 == 0
    tiles = -(-k // _TILE_COLS) * -(-b // _TILE_ROWS)
    return vec_store, 8 if tiles >= sms else 4


@functools.cache
def _kernel():
    fn = load("hellinger_strip").hellinger_strip_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    if k >= 2**31 or rb.shape[1] >= 2**31 or -(-b // _TILE_ROWS) > _MAX_GRID_Y:
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
    index = rb.device.index
    vec_store, rows = tile_choice(b, k, out.data_ptr(), _sms(index))
    err = _kernel()(rb.data_ptr(), r.data_ptr(), out.data_ptr(), b, k, c, vec_store, rows,
                    index, torch.cuda.current_stream(rb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hellinger_strip kernel launch failed: cudaError {err}")
    hellinger_strip.launches += 1
    return out


hellinger_strip.launches = 0  # type: ignore[attr-defined]
