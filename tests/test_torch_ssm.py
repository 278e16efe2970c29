"""Port parity for the Mamba heads of hymba: the same numpy inputs go through
the JAX package and the port on the CPU — the selective scan's plain
version (the CPU path of the kernel) and its gradient, the causal conv,
the block's init and ``mamba_seq`` under shared and per-client weights.

Tolerances: 1e-5 for the fp32 scan, its gradient and ``mamba_seq`` (fp32
sums and exps taken in another order in XLA than in PyTorch; outputs are of
size ~1 to ~10); 1e-4 against the Pallas kernel, as ``tests/test_kernels.py``
holds it; 2e-2 for bf16 inputs (one rounding of the output, of size ~1, to
bf16's 8 mantissa bits, on either side); exact for the conv (the same
multiplies and adds in the same order); 2e-7 for the deterministic init
leaves (a_log = log(1..N): PyTorch's and XLA's fp32 log may differ by one
rounding).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels.mamba_scan.ops import mamba_scan_pallas  # noqa: E402
from repro.kernels.mamba_scan.ref import mamba_scan_ref as ref_mamba_scan  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    mamba_scan,
    mamba_scan_backward,
    mamba_scan_forward,
    mamba_scan_ref,
)
from repro_torch.models import ssm  # noqa: E402

KERNEL_SHAPES = [(2, 64, 32, 8, 32, 32), (1, 128, 256, 16, 64, 128), (2, 100, 130, 16, 64, 128)]
NAMES = ("x", "dt", "bmat", "cmat", "a_log", "d_skip")


def _t(a):
    return torch.from_numpy(np.array(a))


def _scan_inputs(b, s, d, n, seed, groups=0):
    """The sweep's distributions (``tests/test_kernels.py``); ``groups`` > 0
    gives a_log (G, D, N) and d_skip (G, D), perturbed per group."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, (b, s, d)).astype(np.float32)
    dt = np.abs(rng.normal(0.05, 0.02, (b, s, d))).astype(np.float32)
    bm = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    cm = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    al = np.log(np.tile(np.arange(1, n + 1, dtype=np.float32), (d, 1)))
    ds = rng.normal(1, 0.1, (d,)).astype(np.float32)
    if groups:
        al = (al + rng.normal(0, 0.1, (groups, d, n))).astype(np.float32)
        ds = (ds + rng.normal(0, 0.1, (groups, d))).astype(np.float32)
    return [x, dt, bm, cm, al, ds]


# ---------------------------------------------------------------------------
# the scan: plain version (CPU path of the kernel) and its gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,d,n,bt,bd", KERNEL_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_matches_reference_and_pallas(b, s, d, n, bt, bd, dtype):
    x, dt, bm, cm, al, ds = _scan_inputs(b, s, d, n, s + d)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jin = [jnp.asarray(a, jdt) for a in (x, dt, bm, cm)] + [jnp.asarray(al), jnp.asarray(ds)]
    tin = [_t(a).to(tdt) for a in (x, dt, bm, cm)] + [_t(al), _t(ds)]
    got = mamba_scan(*tin)
    assert got.dtype == tdt and got.shape == (b, s, d)
    got = got.to(torch.float32).numpy()
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, np.asarray(ref_mamba_scan(*jin), np.float32), atol=atol)
    pallas = mamba_scan_pallas(*jin, bt=bt, bd=bd, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               atol=1e-4 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("b,s,d,n", [(2, 37, 10, 8), (1, 64, 32, 16)])
def test_scan_gradient_matches_jax_vjp(b, s, d, n):
    ins = _scan_inputs(b, s, d, n, 3 * s + n)
    g = np.random.default_rng(s).normal(0, 1, (b, s, d)).astype(np.float32)
    _, vjp = jax.vjp(ref_mamba_scan, *map(jnp.asarray, ins))
    want = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_(True) for a in ins]
    got = torch.autograd.grad(mamba_scan(*leaves), leaves, _t(g))
    for name, a, w in zip(NAMES, got, want):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5, err_msg=name)


def test_scan_groups_read_their_own_weights():
    """Grouped weights (G, D, N), (G, D): rows [g B/G, (g + 1) B/G) scan with
    group g's weights, values and gradients alike."""
    groups, per = 3, 2
    ins = _scan_inputs(groups * per, 20, 12, 8, 5, groups=groups)
    g = np.random.default_rng(1).normal(0, 1, ins[0].shape).astype(np.float32)
    leaves = [_t(a).requires_grad_(True) for a in ins]
    y = mamba_scan(*leaves)
    got = torch.autograd.grad(y, leaves, _t(g))
    for i in range(groups):
        rows = slice(i * per, (i + 1) * per)
        part = [jnp.asarray(a[rows]) for a in ins[:4]] + [jnp.asarray(ins[4][i]),
                                                          jnp.asarray(ins[5][i])]
        want_y, vjp = jax.vjp(ref_mamba_scan, *part)
        np.testing.assert_allclose(y[rows].detach().numpy(), np.asarray(want_y), atol=1e-5)
        want = vjp(jnp.asarray(g[rows]))
        for name, a, w in zip(NAMES, got, want):
            a = a[rows] if name in NAMES[:4] else a[i]
            np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5, err_msg=name)


def test_scan_wrappers_take_cuda_tensors_only():
    ins = [_t(a) for a in _scan_inputs(2, 9, 6, 4, 0)]
    before = (mamba_scan_forward.launches, mamba_scan_backward.launches)
    leaves = [t.requires_grad_(True) for t in ins]
    mamba_scan(*leaves).sum().backward()  # CPU: the plain version and its autograd
    assert (mamba_scan_forward.launches, mamba_scan_backward.launches) == before
    assert all(t.grad is not None for t in leaves)
    plain = [t.detach() for t in ins]
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_forward(*plain)
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_backward(*plain, plain[0], plain[0])
    with pytest.raises(ValueError, match="G dividing B"):
        mamba_scan(*plain[:4], plain[4].expand(3, 6, 4), plain[5].expand(3, 6))
    with pytest.raises(TypeError, match="float32"):
        mamba_scan(*plain[:4], plain[4].double(), plain[5])
    with pytest.raises(ValueError, match=r"\(B, S, N\)"):
        mamba_scan(plain[0], plain[1], plain[2][:, :5], plain[3][:, :5], plain[4], plain[5])


# ---------------------------------------------------------------------------
# the Mamba block
# ---------------------------------------------------------------------------


def _cfgs(fuse=True):
    ov = {"dtype": "float32", "d_model": 24, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16}
    ref = dataclasses.replace(ref_get_config("hymba-1.5b", reduced=True), **ov)
    ref = dataclasses.replace(ref, ssm=dataclasses.replace(ref.ssm, fuse_contraction=fuse,
                                                           chunk=8))
    return ref, dataclasses.replace(get_config("hymba-1.5b", reduced=True), **ov)


def _ref_block(seed, ref_cfg):
    p = ref_ssm.init_mamba(jax.random.PRNGKey(seed), ref_cfg)
    return p, {k: _t(v) for k, v in p.items()}


def test_mamba_shapes_and_init_follow_reference():
    ref_cfg, cfg = _cfgs()
    ref_p = ref_ssm.init_mamba(jax.random.PRNGKey(0), ref_cfg)
    shapes = ssm.mamba_shapes(cfg)
    assert list(shapes) == list(ref_p)
    assert {k: tuple(v.shape) for k, v in ref_p.items()} == shapes
    p = ssm.init_mamba(torch.Generator().manual_seed(0), dataclasses.replace(cfg, d_model=128))
    assert list(p) == list(shapes)
    ref_big = ref_ssm.init_mamba(jax.random.PRNGKey(0), dataclasses.replace(ref_cfg, d_model=128))
    for name in ("a_log", "b_dt", "d_skip"):  # deterministic leaves (log to within a rounding)
        assert p[name].dtype == torch.float32
        np.testing.assert_allclose(p[name].numpy(), np.asarray(ref_big[name]), rtol=0, atol=2e-7)
    for name, fan_in in [("w_in", 128), ("w_dt", 128), ("w_b", 128), ("w_out", 128)]:
        assert abs(p[name].std().item() * np.sqrt(fan_in) - 1.0) < 0.15, name
    assert abs(p["conv_w"].std().item() / 0.2 - 1.0) < 0.15


def test_causal_conv_matches_reference_exactly():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (3, 11, 7)).astype(np.float32)
    w = rng.normal(0, 1, (4, 7)).astype(np.float32)
    want = np.asarray(ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_array_equal(ssm._causal_conv(_t(x), _t(w)).numpy(), want)


@pytest.mark.parametrize("fuse", [True, False])
def test_mamba_seq_matches_reference_shared_weights(fuse):
    ref_cfg, cfg = _cfgs(fuse)
    ref_p, p = _ref_block(1, ref_cfg)
    x = np.random.default_rng(2).normal(0, 1, (3, 16, 24)).astype(np.float32)
    want, _ = ref_ssm.mamba_seq(ref_p, ref_cfg, jnp.asarray(x))
    got = ssm.mamba_seq(p, cfg, _t(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("fuse", [True, False])
def test_mamba_seq_matches_reference_per_client_weights(fuse):
    """Weights (m, ...) over x (m, B, S, d): client i's rows see its own block,
    values and gradients alike."""
    ref_cfg, cfg = _cfgs(fuse)
    blocks = [_ref_block(seed, ref_cfg) for seed in (3, 4)]
    stacked = {k: torch.stack([p[k] for _, p in blocks]).requires_grad_(True)
               for k in blocks[0][1]}
    x = np.random.default_rng(6).normal(0, 1, (2, 2, 16, 24)).astype(np.float32)
    g = np.random.default_rng(7).normal(0, 1, x.shape).astype(np.float32)
    got = ssm.mamba_seq(stacked, cfg, _t(x))
    grads = torch.autograd.grad(got, list(stacked.values()), _t(g))

    @jax.jit
    def ref_value_and_vjp(p, xi, gi):
        out, vjp = jax.vjp(lambda q: ref_ssm.mamba_seq(q, ref_cfg, xi)[0], p)
        return out, vjp(gi)[0]

    for i, (ref_p, _) in enumerate(blocks):
        want, want_g = ref_value_and_vjp(ref_p, jnp.asarray(x[i]), jnp.asarray(g[i]))
        np.testing.assert_allclose(got[i].detach().numpy(), np.asarray(want), atol=1e-5)
        for name, a in zip(stacked, grads):
            np.testing.assert_allclose(a[i].numpy(), np.asarray(want_g[name]), atol=1e-5,
                                       err_msg=name)
