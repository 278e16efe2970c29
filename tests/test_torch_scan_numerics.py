"""The numerics of K4 (the selective scan), emulated on the CPU before the card runs it.

`src/repro_torch/csrc/mamba_scan.cu` computes abar = exp(dt A) as
`ex2.approx.ftz.f32`(dt A'), with A' = A log2(e) rounded to fp32 once per
state, and holds a channel's 16 states on four lanes of four.  Here every
step of its forward and backward is formed the way the kernel forms it, in
fp32 (a fused multiply-add is an fp64 product and sum rounded once to fp32):

- A = -exp(a_log), A' = A log2(e); a smaller N is zero-padded to 16 states;
- abar = 2^(dt A') times (1 + u 2^-22), u in [-1, 1) a seeded hash of the
  argument's bits, which stands for `ex2.approx` (relative error below
  2^-22) and gives the same value for the same argument, as the card does;
- h = fma(abar, h, (dt x) Bm); a lane's part of a sum over N is its four
  states in state order (the first a product, then fused multiply-adds),
  and the four lanes add as (q0 + q1) + (q2 + q3);
- y = fma(d_skip, x, that sum); the forward keeps the state before every
  8th step;
- the backward walks the 8-step chunks from the last, recomputes each from
  its checkpoint, and runs the reverse recurrence with the kernel's terms:
  u = (dh h_{t-1}) abar; a lane's parts dx_q = (sum dh Bm) dt and ddt_q =
  fma(sum u A', ln 2, x sum dh Bm) over its four states, added over the
  lanes as above, plus d_skip dy for dx; da_log = A sum_t fma(u, dt, .), so
  that A itself is not held per step;
  dBm and dCm sum over the 8 channels of a warp in its butterfly order
  (channel c with c ^ 4, then ^ 2, then ^ 1), then over the 8 warps of a
  64-channel block in warp order, then over blocks in block order; da_log
  and dd_skip sum over t from the last step, then over the rows of a group.

The emulation must stay within the kernel's fp32 tolerance, 2e-5 relative
to max(1, max |plain|), of the port's plain version `mamba_scan_ref` and its
autograd, and of the JAX package's `mamba_scan_ref` and `jax.vjp`, on the
same numpy inputs made as `chip_smoke.py` makes them, at S = 64 (the LM
paths') and S = 2048, for N = 16 (hymba's) and N = 5 (a partly filled lane).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mamba_scan.ref import mamba_scan_ref as jax_mamba_scan_ref  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan_ref  # noqa: E402

TOL = 2e-5  # chip_smoke.py's and tests/test_torch_gpu.py's fp32 tolerance for K4
KN, PER, CHANNELS, CHUNK = 16, 4, 64, 8  # the kernel's kN, kPer, kChannels, kChunk
EX2_ERR = 2.0 ** -22
LN2 = torch.tensor(math.log(2.0), dtype=torch.float32)
NAMES = ("y", "dx", "ddt", "dbmat", "dcmat", "da_log", "dd_skip")

# (B, S, D, N, G): G = 0 shared weights; D = 72 leaves the second 64-channel
# block 8 live channels; S = 100 ends in a ragged chunk
SHAPES = [
    (4, 64, 72, 16, 2),
    (4, 64, 72, 5, 2),
    (2, 2048, 72, 16, 0),
    (2, 2048, 72, 5, 0),
    (3, 100, 130, 16, 0),
]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fma(a, b, c):
    """fp32 fused multiply-add: the exact product plus c, rounded once."""
    return (a.double() * b.double() + c.double()).float()


def ex2(z: torch.Tensor, seed: int) -> torch.Tensor:
    """2^z in fp32 with a relative error of up to 2^-22, a fixed function of
    z's bits (a multiplicative hash, seeded)."""
    bits = z.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    h = (bits * 2654435761 + seed * 40503) % (1 << 32)
    u = h.double() / 2.0 ** 31 - 1.0
    return (torch.exp2(z).double() * (1.0 + u * EX2_ERR)).float()


def lane_parts(h, c):
    """(..., 16) x (..., 16) -> (..., 4): each lane's four states in order."""
    h4, c4 = h.unflatten(-1, (PER, PER)), c.unflatten(-1, (PER, PER))
    part = h4[..., 0] * c4[..., 0]
    for i in range(1, PER):
        part = fma(h4[..., i], c4[..., i], part)
    return part


def lane_sum(part):
    """(..., 4) -> (...): (q0 + q1) + (q2 + q3)."""
    return (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])


def channel_sum(v):
    """(B, S, D, N) -> (B, S, N): the warp's butterfly over its 8 channels,
    the block's 8 warps in order, the blocks in order."""
    b, s, d, n = v.shape
    blocks = -(-d // CHANNELS)
    v = torch.nn.functional.pad(v, (0, 0, 0, blocks * CHANNELS - d))
    v = v.reshape(b, s, blocks, CHANNELS // 8, 2, 2, 2, n)  # channel 4 b2 + 2 b1 + b0
    v = v[..., 0, :, :, :] + v[..., 1, :, :, :]             # c with c ^ 4
    v = v[..., 0, :, :] + v[..., 1, :, :]                   # ... ^ 2
    v = v[..., 0, :] + v[..., 1, :]                         # ... ^ 1: (b, s, blocks, warps, n)
    per_block = v[..., 0, :]
    for w in range(1, CHANNELS // 8):
        per_block = per_block + v[..., w, :]
    total = torch.zeros_like(per_block[:, :, 0])
    for k in range(blocks):
        total = total + per_block[:, :, k]
    return total


def _weights(a_log, d_skip, b):
    """Per-row A, A' (B, D, 16) and d_skip (B, D) from shared or grouped weights."""
    if a_log.ndim == 2:
        a_log, d_skip = a_log[None], d_skip[None]
    per = b // a_log.shape[0]
    a = -torch.exp(a_log.repeat_interleave(per, 0))
    a = torch.nn.functional.pad(a, (0, KN - a.shape[-1]))
    return a, a * np.float32(math.log2(math.e)), d_skip.repeat_interleave(per, 0)


def emulated_forward(x, dt, bm, cm, a_log, d_skip, seed):
    """y (B, S, D) and the checkpoints (B, ceil(S / 8), D, 16) as the kernel
    forms them."""
    b, s, d = x.shape
    _, a2, dsk = _weights(a_log, d_skip, b)
    bm, cm = (torch.nn.functional.pad(t, (0, KN - t.shape[-1])) for t in (bm, cm))
    h = torch.zeros(b, d, KN)
    ys, ckpt = [], []
    for t in range(s):
        if t % CHUNK == 0:
            ckpt.append(h)
        dtt, xt = dt[:, t], x[:, t]
        ab = ex2(dtt[..., None] * a2, seed)
        h = fma(ab, h, (dtt * xt)[..., None] * bm[:, t, None, :])
        ys.append(fma(dsk, xt, lane_sum(lane_parts(h, cm[:, t, None, :].expand_as(h)))))
    return torch.stack(ys, 1), torch.stack(ckpt, 1)


def emulated_backward(x, dt, bm, cm, a_log, d_skip, ckpt, dy, seed):
    """(dx, ddt, dbmat, dcmat, da_log, dd_skip) as the kernel forms them."""
    b, s, d = x.shape
    n = bm.shape[-1]
    a, a2, dsk = _weights(a_log, d_skip, b)
    bm, cm = (torch.nn.functional.pad(t, (0, KN - t.shape[-1])) for t in (bm, cm))
    carry, du = torch.zeros(b, d, KN), torch.zeros(b, d, KN)
    dd = torch.zeros(b, d)
    dx, ddt = torch.zeros(b, s, d), torch.zeros(b, s, d)
    vb, vc = torch.zeros(b, s, d, KN), torch.zeros(b, s, d, KN)
    for c in reversed(range(ckpt.shape[1])):
        t0 = c * CHUNK
        h, hs = ckpt[:, c], []
        for t in range(t0, min(t0 + CHUNK, s)):  # recompute the chunk
            hs.append(h)
            ab = ex2(dt[:, t, :, None] * a2, seed)
            h = fma(ab, h, (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :])
        for j in reversed(range(len(hs))):  # reverse time: h is h_t, hs[j] is h_{t-1}
            t = t0 + j
            xt, dtt, dyt = x[:, t], dt[:, t], dy[:, t]
            bt, ct = (m[:, t, None, :].expand_as(h) for m in (bm, cm))
            ab = ex2(dtt[..., None] * a2, seed)
            dh = fma(dyt[..., None], ct, carry)
            u = (dh * hs[j]) * ab
            vb[:, t] = dh * (dtt * xt)[..., None]
            vc[:, t] = dyt[..., None] * h
            dxs, dus = lane_parts(dh, bt), lane_parts(u, a2)  # (B, D, 4): one per lane
            du = fma(u, dtt[..., None], du)
            carry = ab * dh
            h = hs[j]
            dx[:, t] = lane_sum(dxs * dtt[..., None]) + dsk * dyt
            ddt[:, t] = lane_sum(fma(dus, LN2, xt[..., None] * dxs))
            dd = fma(dyt, xt, dd)
    groups = 1 if a_log.ndim == 2 else a_log.shape[0]
    da = (a * du)[..., :n].reshape(groups, b // groups, d, n)
    dd = dd.reshape(groups, b // groups, d)
    da_log, dd_skip = torch.zeros(groups, d, n), torch.zeros(groups, d)
    for r in range(b // groups):  # the rows of a group in order
        da_log, dd_skip = da_log + da[:, r], dd_skip + dd[:, r]
    if a_log.ndim == 2:
        da_log, dd_skip = da_log[0], dd_skip[0]
    return dx, ddt, channel_sum(vb)[..., :n], channel_sum(vc)[..., :n], da_log, dd_skip


def _inputs(b, s, d, n, groups, seed):
    """chip_smoke.py's recipe, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, d)) * 0.5).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, s, d)) * 0.02 + 0.05).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    wshape = (d, n) if groups == 0 else (groups, d, n)
    a_log = (np.log(np.arange(1, n + 1, dtype=np.float32))
             + 0.1 * rng.standard_normal(wshape)).astype(np.float32)
    d_skip = (1 + 0.1 * rng.standard_normal(wshape[:-1])).astype(np.float32)
    dy = rng.standard_normal((b, s, d)).astype(np.float32)
    return [x, dt, bm, cm, a_log, d_skip], dy


def _jax_reference(ins, dy, groups):
    """y and the six gradients of the JAX package's plain version, one group
    of rows at a time."""
    x = ins[0]
    per = x.shape[0] // max(groups, 1)
    ys, grads = [], []
    for i in range(max(groups, 1)):
        rows = slice(i * per, (i + 1) * per)
        w = (ins[4], ins[5]) if groups == 0 else (ins[4][i], ins[5][i])
        part = [jnp.asarray(a[rows]) for a in ins[:4]] + [jnp.asarray(w[0]), jnp.asarray(w[1])]
        y, vjp = jax.vjp(jax_mamba_scan_ref, *part)
        ys.append(np.asarray(y))
        grads.append([np.asarray(g) for g in vjp(jnp.asarray(dy[rows]))])
    seq = [np.concatenate([g[k] for g in grads]) for k in range(4)]
    if groups == 0:  # one group: the shared weights' gradients as they are
        weights = [grads[0][4], grads[0][5]]
    else:
        weights = [np.stack([g[k] for g in grads]) for k in (4, 5)]
    return [np.concatenate(ys)] + seq + weights


def _check(name, got, want):
    want = torch.from_numpy(np.array(want, np.float32))
    assert got.shape == want.shape, name
    limit = TOL * max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= limit, f"{name}: max |emulated - plain| = {err:.3g} > {limit:.3g}"


@pytest.mark.parametrize("b,s,d,n,groups", SHAPES)
def test_emulated_kernel_matches_plain_versions(b, s, d, n, groups):
    ins, dy = _inputs(b, s, d, n, groups, seed=b * s + d + n + groups)
    tin = [torch.from_numpy(a) for a in ins]
    y, ckpt = emulated_forward(*tin, seed=s)
    assert ckpt.shape == (b, -(-s // CHUNK), d, KN)
    got = [y, *emulated_backward(*tin, ckpt, torch.from_numpy(dy), seed=s)]

    leaves = [t.clone().requires_grad_(True) for t in tin]
    y_ref = mamba_scan_ref(*leaves)
    port = [y_ref.detach(), *torch.autograd.grad(y_ref, leaves, torch.from_numpy(dy))]
    for name, g, w in zip(NAMES, got, port):
        _check(f"{name} vs the port's plain version", g, w.numpy())
    for name, g, w in zip(NAMES, got, _jax_reference(ins, dy, groups)):
        _check(f"{name} vs the JAX package's plain version", g, w)


def test_ex2_model_stays_within_its_error_and_repeats():
    z = torch.from_numpy(np.random.default_rng(0).uniform(-30, 0, 10_000).astype(np.float32))
    rel = (ex2(z, seed=3).double() / torch.exp2(z).double() - 1).abs().max().item()
    assert EX2_ERR / 4 < rel <= EX2_ERR + 2.0 ** -24  # the error, then one rounding to fp32
    assert torch.equal(ex2(z, seed=3), ex2(z.clone(), seed=3))  # the same argument, the same value


def test_lane_and_channel_sums_cover_every_term():
    """Every state of every lane and every channel of every block is summed
    once: the orders differ from a plain sum only by rounding."""
    rng = np.random.default_rng(1)
    h, c = (torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32)) for _ in range(2))
    assert torch.allclose(lane_sum(lane_parts(h, c)), (h * c).sum(-1), atol=1e-5)
    v = torch.from_numpy(rng.standard_normal((2, 3, 130, 5)).astype(np.float32))
    assert torch.allclose(channel_sum(v), v.sum(2), atol=1e-5)
