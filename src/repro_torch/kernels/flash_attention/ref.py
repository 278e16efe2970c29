"""Plain PyTorch version of the causal flash-attention kernel.

A materialised-softmax attention, like ``attention_ref`` in the JAX
package's ``repro/kernels/flash_attention/ref.py``, but in the model
layout (B, S, H, D) with GQA by kv head ``h // (H / KV)``.  Scores,
softmax and products are fp32; the output is cast back to the input type.
It also returns the row log-sum-exp L (B, H, S) fp32 that the kernel's
forward writes for its backward.  Its autograd is the gradient oracle.
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int = 0,
                  is_global: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, S, H, D), k and v (B, S, KV, D) -> (O (B, S, H, D) in q's type,
    L (B, H, S) fp32).  Causal; with ``window > 0`` and ``is_global <= 0``
    a query also sees only the ``window`` latest keys."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.to(torch.float32).reshape(b, s, kv, g, d).permute(0, 2, 3, 1, 4)  # (B, KV, G, S, D)
    kf = k.to(torch.float32).permute(0, 2, 1, 3).unsqueeze(2)               # (B, KV, 1, S, D)
    vf = v.to(torch.float32).permute(0, 2, 1, 3).unsqueeze(2)
    scores = (qg @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    pos = torch.arange(s, device=q.device)
    ok = pos[None, :] <= pos[:, None]
    if window > 0 and not is_global > 0:
        ok = ok & (pos[:, None] - pos[None, :] < window)
    scores = scores.masked_fill(~ok, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)                                  # (B, KV, G, S)
    out = torch.softmax(scores, dim=-1) @ vf                               # (B, KV, G, S, D)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)
    return out, lse.reshape(b, h, s)
