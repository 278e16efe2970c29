"""Wrappers of the selective-scan kernels (``csrc/mamba_scan.cu``).

The port's counterpart of ``mamba_scan_pallas``, with a gradient.  Inputs
in the kernel's layout: x, dt (B, S, D); bmat, cmat (B, S, N); a_log
(D, N) and d_skip (D,) shared by every row, or (G, D, N) and (G, D), one
set per group of B / G consecutive rows (a local-SGD cohort of m clients
is G = m).  ``mamba_scan`` is differentiable: on CUDA tensors that need a
gradient a ``torch.autograd.Function`` runs ``mamba_scan_forward`` with
state checkpoints (one launch) and, for the gradient,
``mamba_scan_backward`` (one launch of the reverse scan, then the second
pass that sums its partials).  Without a gradient the forward writes no
checkpoints.  Each of the two counts its launches in its ``launches``
attribute.  CPU tensors take the plain version (``ref.py``) and its
autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

__all__ = ["mamba_scan", "mamba_scan_forward", "mamba_scan_backward"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS = 65535  # CUDA's limit on gridDim.y (one row of blocks per sequence)
_MAX_STATE = 16    # the kernel keeps up to 16 states a channel in registers


@functools.cache
def _kernels():
    """(forward, backward, (chunk, block)) from the library."""
    lib = load("mamba_scan")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mamba_scan_fwd.argtypes = [i32] + [ptr] * 9 + [i32, ptr]
    lib.mamba_scan_bwd.argtypes = [i32] + [ptr] * 18 + [i32, ptr]
    lib.mamba_scan_fwd.restype = lib.mamba_scan_bwd.restype = i32
    layout = (lib.mamba_scan_chunk(), lib.mamba_scan_block())
    return lib.mamba_scan_fwd, lib.mamba_scan_bwd, layout


def _check(x, dt, bmat, cmat, a_log, d_skip) -> int:
    """Validate the inputs; returns the number of weight groups G."""
    ts = (x, dt, bmat, cmat, a_log, d_skip)
    if len({t.device for t in ts}) != 1 or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the scan's inputs must share one CPU or CUDA device; got "
                         f"{[str(t.device) for t in ts]}")
    if x.dtype not in _DTYPES or not (x.dtype == dt.dtype == bmat.dtype == cmat.dtype):
        raise TypeError(f"x, dt, bmat and cmat must all be float32 or bfloat16; got "
                        f"{x.dtype}, {dt.dtype}, {bmat.dtype}, {cmat.dtype}")
    if a_log.dtype != torch.float32 or d_skip.dtype != torch.float32:
        raise TypeError(f"a_log and d_skip must be float32; got {a_log.dtype}, {d_skip.dtype}")
    if x.ndim != 3 or dt.shape != x.shape or bmat.ndim != 3 or cmat.shape != bmat.shape \
            or bmat.shape[:2] != x.shape[:2]:
        raise ValueError(f"x, dt must be (B, S, D) and bmat, cmat (B, S, N); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(bmat.shape)}, "
                         f"{tuple(cmat.shape)}")
    b, s, d = x.shape
    n = bmat.shape[2]
    groups = 1 if a_log.ndim == 2 else a_log.shape[0]
    if a_log.shape[-2:] != (d, n) or a_log.ndim not in (2, 3) \
            or d_skip.shape != ((d,) if a_log.ndim == 2 else (groups, d)) \
            or groups == 0 or b % groups:
        raise ValueError(f"a_log must be (D, N) or (G, D, N) and d_skip (D,) or (G, D), with G "
                         f"dividing B; got {tuple(a_log.shape)}, {tuple(d_skip.shape)} for x "
                         f"{tuple(x.shape)}, bmat {tuple(bmat.shape)}")
    if x.is_cuda:
        if not all(t.is_contiguous() for t in ts):
            raise ValueError("the kernel takes contiguous tensors")
        if not (0 < b <= _MAX_ROWS and s > 0 and d > 0 and 0 < n <= _MAX_STATE):
            raise ValueError(f"the kernel takes 0 < B <= {_MAX_ROWS}, S > 0, D > 0 and "
                             f"0 < N <= {_MAX_STATE}; got x {tuple(x.shape)}, N {n}")
    return groups


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _call_args(x):
    return x.device.index, torch.cuda.current_stream(x.device).cuda_stream


def mamba_scan_forward(x, dt, bmat, cmat, a_log, d_skip, checkpoints: bool = False):
    """CUDA inputs -> y (B, S, D) in x's type: one launch of the forward
    kernel.  With ``checkpoints`` it returns (y, ckpt), ckpt the fp32 state
    before every chunk-th step, (B, ceil(S / chunk), D, N), which
    ``mamba_scan_backward`` needs."""
    groups = _check(x, dt, bmat, cmat, a_log, d_skip)
    if not x.is_cuda:
        raise ValueError("mamba_scan_forward launches the kernel: pass CUDA tensors")
    fwd, _, (chunk, _) = _kernels()
    b, s, d = x.shape
    n = bmat.shape[2]
    y = torch.empty_like(x)
    ckpt = (torch.empty((b, -(-s // chunk), d, n), dtype=torch.float32, device=x.device)
            if checkpoints else None)
    dims = (ctypes.c_int64 * 5)(b, s, d, n, groups)
    err = fwd(_DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
              a_log.data_ptr(), d_skip.data_ptr(), y.data_ptr(),
              ckpt.data_ptr() if checkpoints else None, dims, *_call_args(x))
    _raise_on(err, "mamba_scan forward")
    mamba_scan_forward.launches += 1
    return (y, ckpt) if checkpoints else y


def mamba_scan_backward(x, dt, bmat, cmat, a_log, d_skip, ckpt, grad_y):
    """Gradients (dx, ddt, dbmat, dcmat, da_log, dd_skip), each in its
    input's shape and type, from the forward's checkpoints: one launch of
    the reverse scan, then one of the second pass."""
    groups = _check(x, dt, bmat, cmat, a_log, d_skip)
    if not x.is_cuda:
        raise ValueError("mamba_scan_backward launches the kernel: pass CUDA tensors")
    _, bwd, (chunk, block) = _kernels()
    b, s, d = x.shape
    n = bmat.shape[2]
    if ckpt.shape != (b, -(-s // chunk), d, n) or ckpt.dtype != torch.float32 \
            or not ckpt.is_contiguous():
        raise ValueError("ckpt must be the forward's contiguous fp32 checkpoints")
    grad_y = grad_y.to(x.dtype).contiguous()
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dbmat, dcmat = torch.empty_like(bmat), torch.empty_like(cmat)
    da_log, dd_skip = torch.empty_like(a_log), torch.empty_like(d_skip)
    f32 = {"dtype": torch.float32, "device": x.device}
    part_bc = torch.empty((-(-d // block), b, s, 32), **f32)
    part_a = torch.empty((b, d, n), **f32)
    part_d = torch.empty((b, d), **f32)
    dims = (ctypes.c_int64 * 5)(b, s, d, n, groups)
    err = bwd(_DTYPES[x.dtype], *(t.data_ptr() for t in (
        x, dt, bmat, cmat, a_log, d_skip, ckpt, grad_y, dx, ddt, dbmat, dcmat, da_log, dd_skip,
        part_bc, part_a, part_d)), dims, *_call_args(x))
    _raise_on(err, "mamba_scan backward")
    mamba_scan_backward.launches += 1
    return dx, ddt, dbmat, dcmat, da_log, dd_skip


mamba_scan_forward.launches = 0   # type: ignore[attr-defined]
mamba_scan_backward.launches = 0  # type: ignore[attr-defined]


class _MambaScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, bmat, cmat, a_log, d_skip):
        y, ckpt = mamba_scan_forward(x, dt, bmat, cmat, a_log, d_skip, checkpoints=True)
        ctx.save_for_backward(x, dt, bmat, cmat, a_log, d_skip, ckpt)
        return y

    @staticmethod
    def backward(ctx, grad_y):
        return mamba_scan_backward(*ctx.saved_tensors, grad_y)


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
               a_log: torch.Tensor, d_skip: torch.Tensor) -> torch.Tensor:
    """Selective scan y (B, S, D) in x's type, differentiable in all six
    inputs.  CUDA tensors run the kernels (the forward, and under autograd
    the backward); CPU tensors the plain version."""
    _check(x, dt, bmat, cmat, a_log, d_skip)
    if x.device.type == "cpu":
        return mamba_scan_ref(x, dt, bmat, cmat, a_log, d_skip)
    inputs = (x, dt, bmat, cmat, a_log, d_skip)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _MambaScan.apply(*inputs)
    return mamba_scan_forward(*inputs)
