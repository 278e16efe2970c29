"""The numerics of K3's fp32 path, emulated on the CPU before the card runs it.

`src/repro_torch/csrc/flash_attention.cu` runs fp32 attention on the tensor
cores as 3xTF32: each operand x of a product is split as x = big + small,
big = tf32(x) rounded to nearest (ties away from zero, as
`cvt.rna.tf32.f32` rounds) on the low 13 of fp32's 23 mantissa bits, small
= x - big as it is, of which the tensor core reads the top 10 mantissa bits
(modelled here as truncation), and a b is summed as small.big + big.small +
big.big in fp32.  A product of two tf32 values is exact in fp32 (11 x 11
significant bits), so an fp32 matmul of tf32 operands reproduces what the
tensor core sums, up to the order of the sum.

Here every product of the kernel's forward (S = Q K^T, O = P V) and backward
(dP = dO V^T, dQ = dS K, dK = dS^T Q, dV = P^T dO) is formed that way, at
small versions of the shapes `chip_smoke.py` holds K3 to, from numpy inputs
made from a seed.  3xTF32 must stay within the kernel's fp32 tolerance, 2e-5
relative to max(1, max |plain|), of the full-fp32 plain version and of the
JAX package's reference; plain TF32 (big.big alone) must not, which is why
the kernel pays for three products.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402

TOL = 2e-5  # chip_smoke.py's and tests/test_torch_gpu.py's fp32 tolerance for K3

# (B, S, H, KV, D, window, is_global): the K3 list cut to a few rows and heads
SHAPES = [
    (2, 64, 4, 4, 80, 0, 1.0),       # stablelm's local SGD and poll (S = 64, D = 80)
    (2, 64, 5, 1, 64, 1024, 0.0),    # hymba's (GQA group 5, the window never bites)
    (1, 128, 4, 2, 128, 32, 0.0),    # GQA with a window that bites, D = 128
    (1, 96, 2, 1, 256, 0, 1.0),      # the largest D
    (1, 77, 2, 2, 20, 0, 1.0),       # D padded to the MMA depth, ragged S
]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 as `cvt.rna.tf32.f32` does: to nearest on the low
    13 mantissa bits, ties away from zero; the low 13 bits come out zero."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF  # sign-magnitude: adding half a step rounds ties away
    return bits.view(torch.float32)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """The top 10 mantissa bits of fp32, as the tensor core reads a TF32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big = tf32(x)
    return big, truncate_tf32(x - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (ab, as_), (bb, bs) = split(a), split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)  # big.big alone


def emulated(q, k, v, do, window, is_global, mm):
    """K3's forward and backward with every product formed by ``mm``: q (B,
    S, H, D), k and v (B, S, KV, D) fp32 -> O, L, dq, dk, dv in the model
    layout; softmax, statistics and elementwise steps in fp32, as in the
    kernel."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qh = q.permute(0, 2, 1, 3)                                    # (B, H, S, D)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)        # (B, H, S, D)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    doh = do.permute(0, 2, 1, 3)
    scale = 1.0 / math.sqrt(d)
    pos = torch.arange(s)
    ok = pos[None, :] <= pos[:, None]
    if window > 0 and not is_global > 0:
        ok = ok & (pos[:, None] - pos[None, :] < window)
    scores = (mm(qh, kh.transpose(-1, -2)) * scale).masked_fill(~ok, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.exp(scores - lse[..., None])
    o = mm(p, vh)
    delta = (doh * o).sum(-1, keepdim=True)
    ds = p * (mm(doh, vh.transpose(-1, -2)) - delta)
    dq = mm(ds, kh) * scale
    dk = (mm(ds.transpose(-1, -2), qh) * scale).reshape(b, kv, g, s, d).sum(2)
    dv = mm(p.transpose(-1, -2), doh).reshape(b, kv, g, s, d).sum(2)
    back = lambda t: t.permute(0, 2, 1, 3).contiguous()  # noqa: E731
    return back(o), lse, back(dq), back(dk), back(dv)


def _inputs(b, s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, n, d), dtype=np.float32))
            for n in (h, kv, kv, h)]


def _plain(q, k, v, do, window, is_global):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = attention_ref(*leaves, window, is_global)
    grads = torch.autograd.grad(o, leaves, do)
    return (o.detach(), lse.detach(), *grads)


def _rel_errors(got, want):
    names = ("o", "lse", "dq", "dk", "dv")
    return {n: (a - w).abs().max().item() / max(1.0, w.abs().max().item())
            for n, a, w in zip(names, got, want)}


def test_tf32_rounding_is_round_to_nearest_ties_away():
    step = 2.0 ** -10  # one TF32 ulp at 1.0
    x = torch.tensor([1.0, 1.0 + step / 4, 1.0 + step / 2, 1.0 + 3 * step / 4,
                      -(1.0 + step / 2), 3.0e-39, float("inf")], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0, 1.0 + step, 1.0 + step, -(1.0 + step), 3.0e-39, float("inf")],
                        dtype=torch.float32)
    got = tf32(x)
    assert torch.equal(got[:5], want[:5]) and got[6] == want[6]
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert torch.equal(truncate_tf32(x[:4]), torch.ones(4))
    big, small = split(torch.tensor([math.pi], dtype=torch.float32))
    assert abs((big + small).item() - math.pi) < 2.0 ** -20 * math.pi


@pytest.mark.parametrize("b,s,h,kv,d,window,is_global", SHAPES)
def test_3xtf32_attention_and_gradient_within_fp32_tolerance(b, s, h, kv, d, window, is_global):
    q, k, v, do = _inputs(b, s, h, kv, d, seed=b * s + h * d)
    errs = _rel_errors(emulated(q, k, v, do, window, is_global, mm_3xtf32),
                       _plain(q, k, v, do, window, is_global))
    assert all(e <= TOL for e in errs.values()), errs


@pytest.mark.parametrize("b,s,h,kv,d,window,is_global", SHAPES)
def test_plain_tf32_breaks_fp32_tolerance(b, s, h, kv, d, window, is_global):
    q, k, v, do = _inputs(b, s, h, kv, d, seed=b * s + h * d)
    errs = _rel_errors(emulated(q, k, v, do, window, is_global, mm_tf32),
                       _plain(q, k, v, do, window, is_global))
    assert max(errs.values()) > TOL, errs


@pytest.mark.parametrize("b,s,h,kv,d,window,is_global", SHAPES[:3])
def test_3xtf32_forward_matches_jax_reference(b, s, h, kv, d, window, is_global):
    q, k, v, do = _inputs(b, s, h, kv, d, seed=b * s + h * d)
    o = emulated(q, k, v, do, window, is_global, mm_3xtf32)[0]
    g = h // kv
    to_bhsd = lambda t, rep: jnp.asarray(np.repeat(t.numpy().transpose(0, 2, 1, 3), rep, axis=1))  # noqa: E731
    want = np.asarray(jax_attention_ref(to_bhsd(q, 1), to_bhsd(k, g), to_bhsd(v, g), window,
                                        is_global)).transpose(0, 2, 1, 3)
    err = np.abs(o.numpy() - want).max() / max(1.0, np.abs(want).max())
    assert err <= TOL, err
