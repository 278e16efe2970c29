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
checkpoints.  On request the forward also writes the state after the
last step (``final_state``): the Mamba state that a prefill hands to
decode.  Each of the two counts its launches in its ``launches``
attribute, or in ``captured`` for a launch recorded into a CUDA graph,
which runs at each replay rather than when the wrapper is called.  CPU
tensors take the plain version (``ref.py``) and its autograd.

``meta`` tensors take the CUDA path without its launch (the dry run's
``repro_torch.launch.dryrun``): the same checks, and the outputs and
temporaries that the CUDA path allocates (y, the checkpoints, the final
state; the six gradients and the backward's partials) as empty ``meta``
tensors.  Inside ``build.plain_on_meta`` they take the plain version
instead.  Every call on CUDA or ``meta`` tensors adds ``scan_call_work``'s
numbers to the active work tallies (``build.work_tally``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import (
    Work,
    count_launch,
    kernel_path,
    launch_or_meta,
    load,
    tally_kernel,
)
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

__all__ = ["mamba_scan", "mamba_scan_forward", "mamba_scan_backward", "scan_work",
           "scan_call_work"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS = 65535  # CUDA's limit on gridDim.y (one row of blocks per sequence)
_MAX_STATE = 16    # the kernel keeps up to 16 states a channel in registers
# csrc/mamba_scan.cu's kChunk (steps between checkpoints) and kChannels
# (channels a block); the library reports both, and its first load checks
# them against these
_CHUNK, _BLOCK = 8, 64


def scan_work(shape, groups, elem, final_state=False):
    """(forward bytes, backward bytes, (b, t, d, n) elements) of K4 at
    (B, S, D, N) with ``groups`` weight sets and ``elem``-byte sequences:
    each input read once, each output written once (with ``final_state``
    also the (B, D, N) fp32 state after the last step).  The state
    checkpoints that the forward keeps for the backward are this design's
    choice, not the function's, and are not counted."""
    b, s, d, n = shape
    seq, state = b * s * d * elem, b * s * n * elem
    weights = 4 * groups * d * (n + 1)
    fwd = 2 * seq + 2 * state + weights + seq + (4 * b * d * n if final_state else 0)
    bwd = 3 * seq + 2 * state + weights + 2 * seq + 2 * state + weights    # ..., dy -> six grads
    return fwd, bwd, b * s * d * n


def scan_call_work(shape, groups, elem, final_state: bool, backward: bool) -> Work:
    """One forward (or backward) call's ``Work``.  Product flops: those of
    the reference's scan formulation, whose only product is the C
    contraction y = einsum(h, C), 2 B S D N forward and twice that
    backward (dh and dC); its decay, drive and scan are elementwise.  The
    kernel's flops: 5 an element forward (dt A, the state update, the C
    contraction), 16 backward (the recurrence again, then the reverse one
    and its six gradient terms)."""
    fwd, bwd, elements = scan_work(shape, groups, elem, final_state)
    if backward:
        return Work(4.0 * elements, 16.0 * elements, bwd)
    return Work(2.0 * elements, 5.0 * elements, fwd)


@functools.cache
def _kernels():
    """(forward, backward) from the library."""
    lib = load("mamba_scan")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mamba_scan_fwd.argtypes = [i32] + [ptr] * 10 + [i32, ptr]
    lib.mamba_scan_bwd.argtypes = [i32] + [ptr] * 18 + [i32, ptr]
    lib.mamba_scan_fwd.restype = lib.mamba_scan_bwd.restype = i32
    layout = (lib.mamba_scan_chunk(), lib.mamba_scan_block())
    if layout != (_CHUNK, _BLOCK):
        raise RuntimeError(f"csrc/mamba_scan.cu has (chunk, block) {layout}; ops.py assumes "
                           f"{(_CHUNK, _BLOCK)}")
    return lib.mamba_scan_fwd, lib.mamba_scan_bwd


def _check(x, dt, bmat, cmat, a_log, d_skip) -> int:
    """Validate the inputs; returns the number of weight groups G."""
    ts = (x, dt, bmat, cmat, a_log, d_skip)
    if len({t.device for t in ts}) != 1 or x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"the scan's inputs must share one CPU, CUDA or meta device; got "
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
    if kernel_path(x) != "plain":
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


def mamba_scan_forward(x, dt, bmat, cmat, a_log, d_skip, checkpoints: bool = False,
                       final_state: bool = False):
    """CUDA inputs -> y (B, S, D) in x's type: one launch of the forward
    kernel.  With ``checkpoints`` it also returns ckpt, the fp32 state
    before every chunk-th step, (B, ceil(S / chunk), D, N), which
    ``mamba_scan_backward`` needs; with ``final_state`` the fp32 state after
    the last step, (B, D, N).  The result is y alone, or the tuple (y,
    ckpt?, h_final?) of what was asked for (on ``meta`` tensors, the same
    outputs and no launch)."""
    groups = _check(x, dt, bmat, cmat, a_log, d_skip)
    launch = launch_or_meta(x, "mamba_scan_forward")
    b, s, d = x.shape
    n = bmat.shape[2]
    y = torch.empty_like(x)
    f32 = {"dtype": torch.float32, "device": x.device}
    ckpt = torch.empty((b, -(-s // _CHUNK), d, n), **f32) if checkpoints else None
    h_fin = torch.empty((b, d, n), **f32) if final_state else None
    outs = (y,) + ((ckpt,) if checkpoints else ()) + ((h_fin,) if final_state else ())
    tally_kernel("mamba_scan_forward",
                 scan_call_work((b, s, d, n), groups, x.element_size(), final_state, False))
    if not launch:
        return outs if len(outs) > 1 else y
    fwd, _ = _kernels()
    dims = (ctypes.c_int64 * 5)(b, s, d, n, groups)
    err = fwd(_DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
              a_log.data_ptr(), d_skip.data_ptr(), y.data_ptr(),
              ckpt.data_ptr() if checkpoints else None,
              h_fin.data_ptr() if final_state else None, dims, *_call_args(x))
    _raise_on(err, "mamba_scan forward")
    count_launch(mamba_scan_forward)
    return outs if len(outs) > 1 else y


def mamba_scan_backward(x, dt, bmat, cmat, a_log, d_skip, ckpt, grad_y):
    """Gradients (dx, ddt, dbmat, dcmat, da_log, dd_skip), each in its
    input's shape and type, from the forward's checkpoints: one launch of
    the reverse scan, then one of the second pass (on ``meta`` tensors, the
    same outputs and no launch)."""
    groups = _check(x, dt, bmat, cmat, a_log, d_skip)
    launch = launch_or_meta(x, "mamba_scan_backward")
    b, s, d = x.shape
    n = bmat.shape[2]
    if ckpt.shape != (b, -(-s // _CHUNK), d, n) or ckpt.dtype != torch.float32 \
            or not ckpt.is_contiguous():
        raise ValueError("ckpt must be the forward's contiguous fp32 checkpoints")
    grad_y = grad_y.to(x.dtype).contiguous()
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dbmat, dcmat = torch.empty_like(bmat), torch.empty_like(cmat)
    da_log, dd_skip = torch.empty_like(a_log), torch.empty_like(d_skip)
    f32 = {"dtype": torch.float32, "device": x.device}
    part_bc = torch.empty((-(-d // _BLOCK), b, s, 32), **f32)
    part_a = torch.empty((b, d, n), **f32)
    part_d = torch.empty((b, d), **f32)
    tally_kernel("mamba_scan_backward",
                 scan_call_work((b, s, d, n), groups, x.element_size(), False, True))
    if not launch:
        return dx, ddt, dbmat, dcmat, da_log, dd_skip
    _, bwd = _kernels()
    dims = (ctypes.c_int64 * 5)(b, s, d, n, groups)
    err = bwd(_DTYPES[x.dtype], *(t.data_ptr() for t in (
        x, dt, bmat, cmat, a_log, d_skip, ckpt, grad_y, dx, ddt, dbmat, dcmat, da_log, dd_skip,
        part_bc, part_a, part_d)), dims, *_call_args(x))
    _raise_on(err, "mamba_scan backward")
    count_launch(mamba_scan_backward)
    return dx, ddt, dbmat, dcmat, da_log, dd_skip


for _wrapper in (mamba_scan_forward, mamba_scan_backward):
    _wrapper.launches = 0  # type: ignore[attr-defined]
    _wrapper.captured = 0  # type: ignore[attr-defined]


class _MambaScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, bmat, cmat, a_log, d_skip, final_state):
        outs = mamba_scan_forward(x, dt, bmat, cmat, a_log, d_skip, checkpoints=True,
                                  final_state=final_state)
        ctx.save_for_backward(x, dt, bmat, cmat, a_log, d_skip, outs[1])
        if not final_state:
            return outs[0]
        ctx.mark_non_differentiable(outs[2])
        return outs[0], outs[2]

    @staticmethod
    def backward(ctx, grad_y, *_):
        return *mamba_scan_backward(*ctx.saved_tensors, grad_y), None


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
               a_log: torch.Tensor, d_skip: torch.Tensor, final_state: bool = False):
    """Selective scan y (B, S, D) in x's type, differentiable in all six
    inputs.  CUDA tensors run the kernels (the forward, and under autograd
    the backward); CPU tensors the plain version.  With ``final_state`` it
    returns (y, h_final), h_final the fp32 state after the last step (B,
    D, N) from the same forward launch; on CUDA tensors no gradient flows
    back through h_final.  ``meta`` tensors take the CUDA path without its
    launches."""
    _check(x, dt, bmat, cmat, a_log, d_skip)
    inputs = (x, dt, bmat, cmat, a_log, d_skip)
    if kernel_path(x) == "plain":
        return mamba_scan_ref(*inputs, final_state=final_state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _MambaScan.apply(*inputs, final_state)
    return mamba_scan_forward(*inputs, final_state=final_state)
