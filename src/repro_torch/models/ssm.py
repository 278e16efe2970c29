"""Selective-SSM (Mamba) heads of hymba, ported from the Mamba half of
``repro.models.ssm`` (the xLSTM half comes with the xlstm slice).

- ``mamba_shapes`` / ``init_mamba`` — one block's parameters, in the
  reference's key order and with its distributions.
- ``mamba_seq`` — the full-sequence block: input projection, depthwise
  causal conv, SiLU, discretisation, the selective scan, the SiLU gate and
  the output projection.

Weights arrive shared by the whole batch, x (..., S, d), or one set per
client, x (m, B, S, d) with every leaf carrying a leading m axis, as
``linear`` / ``per_client`` in ``models/common.py`` take them.

The discretisation computes only dt = softplus(x w_dt + b_dt), B = x w_b
and C = x w_c, (..., S, D) and (..., S, N); the (B, S, D, N) decay and
drive of the reference's ``_ssm_coeffs`` are never built: the scan
(``repro_torch.kernels.mamba_scan``) discretises inside its own time loop,
as the TPU kernel does.  On CUDA tensors it runs the hand-written kernel,
forward and backward; on CPU tensors its plain version.  The reference's
``ssm.fuse_contraction`` and ``ssm.chunk`` choose the layout of its JAX
associative scan; neither changes a number, and neither has a counterpart
here.  ``mamba_seq`` returns the block output only: the state and
conv-tail carry for decode come with the decode slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.models.common import lecun_init, linear, per_client

__all__ = ["mamba_shapes", "init_mamba", "mamba_seq"]


def mamba_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Parameter shapes of one Mamba block, in the reference's key order.
    hymba's SSM heads run at model width: d_inner = d_model."""
    d, n, k = cfg.d_model, cfg.ssm.d_state, cfg.ssm.conv_kernel
    d_in = d
    return {"w_in": (d, 2 * d_in), "conv_w": (k, d_in), "a_log": (d_in, n), "w_dt": (d_in,),
            "b_dt": (d_in,), "w_b": (d_in, n), "w_c": (d_in, n), "d_skip": (d_in,),
            "w_out": (d_in, d)}


def init_mamba(generator: torch.Generator, cfg) -> dict[str, torch.Tensor]:
    """fp32 parameters drawn from ``generator`` on its device with the
    reference's distributions: LeCun projections, N(0, 0.2^2) conv taps,
    a_log = log(1..N) on every channel, dt bias -4.6 (softplus ~ 0.01),
    unit skip."""
    shapes = mamba_shapes(cfg)
    dev = generator.device
    d_in, n = shapes["a_log"]
    return {
        "w_in": lecun_init(generator, shapes["w_in"]),
        "conv_w": torch.randn(shapes["conv_w"], generator=generator, device=dev) * 0.2,
        "a_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev)).repeat(d_in, 1),
        "w_dt": lecun_init(generator, shapes["w_dt"], fan_in=d_in),
        "b_dt": torch.full(shapes["b_dt"], -4.6, device=dev),
        "w_b": lecun_init(generator, shapes["w_b"]),
        "w_c": lecun_init(generator, shapes["w_c"]),
        "d_skip": torch.ones(shapes["d_skip"], device=dev),
        "w_out": lecun_init(generator, shapes["w_out"]),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as shifted adds, in the reference's order.
    x (..., S, D) with taps w (k, D), or x (m, B, S, D) with w (m, k, D)."""
    k, s = w.shape[-2], x.shape[-2]
    out = x * per_client(w[..., k - 1, :], x)
    for i in range(1, k):
        shifted = F.pad(x, (0, 0, i, 0))[..., :s, :]
        out = out + shifted * per_client(w[..., k - 1 - i, :], x)
    return out


def _discretize(p, x_in: torch.Tensor):
    """(dt (..., S, D), B (..., S, N), C (..., S, N))."""
    dt = F.softplus(x_in * per_client(p["w_dt"], x_in) + per_client(p["b_dt"], x_in))
    return dt, linear(x_in, p["w_b"]), linear(x_in, p["w_c"])


def mamba_seq(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence selective SSM: x (..., S, d) -> (..., S, d)."""
    s = x.shape[-2]
    raw, z = linear(x, p["w_in"]).chunk(2, dim=-1)
    x_in = F.silu(_causal_conv(raw, p["conv_w"]))
    dt, bmat, cmat = _discretize(p, x_in)
    d_in, n = x_in.shape[-1], bmat.shape[-1]
    rows = math.prod(x_in.shape[:-2])
    y = mamba_scan(x_in.reshape(rows, s, d_in), dt.reshape(rows, s, d_in),
                   bmat.reshape(rows, s, n), cmat.reshape(rows, s, n),
                   p["a_log"].contiguous(), p["d_skip"].contiguous())
    return linear(y.reshape(x_in.shape) * F.silu(z), p["w_out"])
