"""Wrappers of the causal flash-attention kernels (``csrc/flash_attention.cu``).

The port's counterpart of ``flash_attention_pallas``, and a drop-in for
the model's ``flash_attention``, in the model layout: q (B, S, H, D), k and
v (B, S, KV, D), read in place through their strides (no transpose and no
GQA repeat).  ``flash_attention`` is differentiable: on CUDA tensors a
``torch.autograd.Function`` runs ``flash_attention_forward`` (one launch:
O and the row log-sum-exp L) and, for the gradient,
``flash_attention_backward`` (one launch of the dQ kernel, which also
writes delta = rowsum(dO * O), then one of the dK/dV kernel).  Each of the
two counts its launches in its ``launches`` attribute, or in ``captured``
for a launch recorded into a CUDA graph.  The kernels
multiply on the tensor cores (bf16, or fp32 as 3xTF32) and read q, k and
v through their strides, which must be 1 on D: a CUDA tensor with another
stride raises, it is never copied.  CPU tensors take the plain version
(``ref.py``) and its autograd.

``meta`` tensors take the CUDA path without its launch (the dry run's
``repro_torch.launch.dryrun``): the same checks, the same outputs and
temporaries (O and the fp32 L forward; dq, dk, dv and delta backward) as
empty ``meta`` tensors, and no S x S tensor.  Inside
``build.plain_on_meta`` they take the plain version instead.  Every call
on CUDA or ``meta`` tensors adds ``attention_work``'s numbers to the
active work tallies (``build.work_tally``).
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
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "flash_attention_forward", "flash_attention_backward",
           "attention_work", "attention_call_work"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256
_MAX_GRID = 65535  # CUDA's limit on gridDim.y (heads) and gridDim.z (batch)


@functools.cache
def _kernels():
    lib = load("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [i32] + [ptr] * 7 + [i32, i32, i32, ptr]
    lib.flash_attention_bwd.argtypes = [i32] + [ptr] * 12 + [i32, i32, i32, ptr]
    lib.flash_attention_fwd.restype = lib.flash_attention_bwd.restype = i32
    return lib.flash_attention_fwd, lib.flash_attention_bwd


def attention_work(shape, window, is_global, elem):
    """(visible (q, k) pairs, bytes forward, bytes backward) of K3 at
    (B, S, H, KV, D) with ``elem``-byte inputs: each input read once, each
    output written once."""
    b, s, h, kv, d = shape
    if window > 0 and not is_global > 0:
        pairs = sum(min(i + 1, window) for i in range(s))
    else:
        pairs = s * (s + 1) // 2
    q_bytes, kv_bytes, stat = b * s * h * d * elem, b * s * kv * d * elem, 4 * b * h * s
    fwd = q_bytes + 2 * kv_bytes + q_bytes + stat                     # q, k, v -> O, L
    bwd = 3 * q_bytes + 2 * kv_bytes + stat + q_bytes + 2 * kv_bytes  # q, k, v, O, dO, L -> dq, dk, dv
    return b * h * pairs, fwd, bwd


def attention_call_work(shape, window, is_global, elem, backward: bool) -> Work:
    """One forward (or backward) call's ``Work``.  Product flops: the
    reference's attention takes the whole S x S square whatever the window
    (two products forward, Q K^T and P V; four backward), 2 B H S^2 D each.
    The kernel's flops: the visible pairs only, 4 D a pair forward and 10 D
    backward (Q K^T recomputed, then dP, dV, dQ and dK)."""
    b, s, h, _, d = shape
    pairs, fwd, bwd = attention_work(shape, window, is_global, elem)
    square = 2.0 * b * h * s * s * d
    if backward:
        return Work(4 * square, 10.0 * d * pairs, bwd)
    return Work(2 * square, 4.0 * d * pairs, fwd)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device == k.device == v.device) or q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(
            f"q, k and v must share one CPU, CUDA or meta device; got {q.device}, {k.device}, "
            f"{v.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v must all be float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"q must be (B, S, H, D) and k, v (B, S, KV, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or h % k.shape[2] != 0:
        raise ValueError(f"k and v {tuple(k.shape)} do not fit q {tuple(q.shape)}: "
                         "same B, S and D, and KV must divide H")
    kernel = kernel_path(q) != "plain"
    if kernel and not (0 < d <= _MAX_D and 0 < s and 0 < b <= _MAX_GRID and h <= _MAX_GRID):
        raise ValueError(f"the kernel takes 0 < D <= {_MAX_D}, S > 0, B and H <= {_MAX_GRID}; "
                         f"got q {tuple(q.shape)}")
    if kernel and any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the kernel reads q, k and v in place and needs unit stride on D; got "
                         f"strides {q.stride()}, {k.stride()}, {v.stride()}")


def _dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    b, s, h, d = q.shape
    dims = (ctypes.c_int64 * 5)(b, s, h, k.shape[2], d)
    strides = (ctypes.c_int64 * 12)(*q.stride(), *k.stride(), *v.stride())
    return dims, strides


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _work(q, k, window, is_global, backward: bool) -> Work:
    b, s, h, d = q.shape
    return attention_call_work((b, s, h, k.shape[2], d), window, is_global, q.element_size(),
                               backward)


def flash_attention_forward(q, k, v, window: int = 0, is_global: float = 1.0):
    """CUDA q (B, S, H, D), k and v (B, S, KV, D) -> (O (B, S, H, D) in the
    input type, L (B, H, S) fp32): one launch of the forward kernel (on
    ``meta`` tensors, the outputs and no launch)."""
    _check(q, k, v)
    launch = launch_or_meta(q, "flash_attention_forward")
    b, s, h, d = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    tally_kernel("flash_attention_forward", _work(q, k, window, is_global, False))
    if not launch:
        return o, lse
    dims, strides = _dims(q, k, v)
    fwd, _ = _kernels()
    err = fwd(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              lse.data_ptr(), dims, strides, int(window), int(is_global > 0),
              q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention forward")
    count_launch(flash_attention_forward)
    return o, lse


def flash_attention_backward(q, k, v, o, lse, grad_out, window: int = 0, is_global: float = 1.0):
    """Gradients (dq, dk, dv) in the input type from the forward's O and L:
    one launch of the dQ kernel, then one of the dK/dV kernel (on ``meta``
    tensors, the outputs and no launch)."""
    _check(q, k, v)
    launch = launch_or_meta(q, "flash_attention_backward")
    if o.shape != q.shape or not o.is_contiguous() or lse.dtype != torch.float32:
        raise ValueError("o must be the forward's contiguous output and lse its fp32 L")
    grad_out = grad_out.to(q.dtype).contiguous()
    b, s, h, _ = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lse = lse.contiguous()
    tally_kernel("flash_attention_backward", _work(q, k, window, is_global, True))
    if not launch:
        return dq, dk, dv
    dims, strides = _dims(q, k, v)
    _, bwd = _kernels()
    err = bwd(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              grad_out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
              dk.data_ptr(), dv.data_ptr(), dims, strides, int(window), int(is_global > 0),
              q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention backward")
    count_launch(flash_attention_backward)
    return dq, dk, dv


for _wrapper in (flash_attention_forward, flash_attention_backward):
    _wrapper.launches = 0  # type: ignore[attr-defined]
    _wrapper.captured = 0  # type: ignore[attr-defined]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window, is_global):
        o, lse = flash_attention_forward(q, k, v, window, is_global)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.is_global = window, is_global
        return o

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, grad_out, ctx.window, ctx.is_global)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int = 0,
                    is_global: float = 1.0) -> torch.Tensor:
    """Causal attention q (B, S, H, D), k and v (B, S, KV, D) -> (B, S, H, D)
    in q's type, differentiable in q, k and v.  CUDA tensors run the
    kernels (forward, and backward under autograd), ``meta`` tensors the
    same path without the launches; CPU tensors the plain version."""
    _check(q, k, v)
    if kernel_path(q) == "plain":
        return attention_ref(q, k, v, window, is_global)[0]
    return _FlashAttention.apply(q, k, v, int(window), float(is_global))
