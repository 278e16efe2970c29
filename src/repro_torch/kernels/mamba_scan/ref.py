"""Plain PyTorch version of the selective-scan kernel.

The recurrence of ``mamba_scan_ref`` in the JAX package's
``repro/kernels/mamba_scan/ref.py``: a loop over S with the state h
(B, D, N) in fp32, then y = h . C + D x, cast back to x's type.  The
weights a_log and d_skip are shared, (D, N) and (D,), or one set per
group of rows, (G, D, N) and (G, D), row b reading group b // (B / G), as
the kernel takes them.  On request it also returns the state after the
last step, as the kernel's forward writes it for decode.  Its autograd is the gradient oracle and the CPU
path's gradient.
"""

from __future__ import annotations

import torch

__all__ = ["mamba_scan_ref"]


def _per_row(w: torch.Tensor, rows: int, ndim: int) -> torch.Tensor:
    """Shared weights (...) or grouped (G, ...) -> one set per row (B, ...)."""
    if w.ndim == ndim:
        return w.unsqueeze(0)
    return w.repeat_interleave(rows // w.shape[0], dim=0)


def mamba_scan_ref(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                   a_log: torch.Tensor, d_skip: torch.Tensor, final_state: bool = False):
    """x, dt (B, S, D); bmat, cmat (B, S, N); a_log (D, N) or (G, D, N);
    d_skip (D,) or (G, D) -> y (B, S, D) in x's type; with ``final_state``
    (y, h), h the fp32 state after the last step (B, D, N)."""
    b, s, _ = x.shape
    a_cont = -torch.exp(_per_row(a_log.to(torch.float32), b, 2))          # (B or 1, D, N)
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    bf, cf = bmat.to(torch.float32), cmat.to(torch.float32)
    h = torch.zeros(b, x.shape[2], bmat.shape[2], dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        a_t = torch.exp(dtf[:, t, :, None] * a_cont)                        # (B, D, N)
        h = a_t * h + (dtf[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :]
        ys.append((h * cf[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) + xf * _per_row(d_skip.to(torch.float32), b, 1)[:, None, :]
    return (y.to(x.dtype), h) if final_state else y.to(x.dtype)
