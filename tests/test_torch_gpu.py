"""The port's CUDA kernels and engine on the card.  Every test here needs
a CUDA device and skips without one; it imports neither JAX nor the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The Hellinger and FedAvg kernels repeat their plain version's arithmetic
operation for operation (fp32, separately rounded multiply and add, index
order), so they must agree with it exactly.  The flash-attention kernels
multiply on the tensor cores (fp32 as 3xTF32, which keeps about 21
mantissa bits of each operand) and sum over D and S in another order than
the plain version's matrix products, so they agree within 2e-5 in fp32
and 1e-2 in bf16 (one rounding to 8 mantissa bits), relative to max(1,
max |plain|); they use no atomics, so two runs give the same bits.  So do the
selective-scan kernels, which sum over N, channels, rows and steps in
another order than the plain version's loop."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import make_classification, make_token_stream  # noqa: E402
from repro_torch.engine import FLConfig, make_engine  # noqa: E402
from repro_torch.kernels.aggregate import masked_weighted_sum, masked_weighted_sum_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref,
    flash_attention,
    flash_attention_backward,
    flash_attention_forward,
)
from repro_torch.kernels.hellinger import hellinger_strip, hellinger_strip_ref  # noqa: E402
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    mamba_scan,
    mamba_scan_backward,
    mamba_scan_forward,
    mamba_scan_ref,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch.cuda.is_available() is False")
    return torch.device("cuda")


def _panel(n, c, g):
    h = torch.rand(n, c, generator=g) * (torch.rand(n, c, generator=g) > 0.3)
    return torch.sqrt(h / torch.clamp(h.sum(1, keepdim=True), min=1e-12))


@pytest.mark.parametrize("b,k,c", [(1, 1, 1), (100, 100, 10), (37, 70, 130),
                                   (300, 1000, 10), (33, 65, 32), (64, 64, 33)])
def test_hellinger_kernel_matches_plain(cuda, b, k, c):
    g = torch.Generator().manual_seed(b * k + c)
    rb, r = _panel(b, c, g).to(cuda), _panel(k, c, g).to(cuda)
    before = hellinger_strip.launches
    got = hellinger_strip(rb, r)
    torch.cuda.synchronize()
    assert hellinger_strip.launches == before + 1
    assert got.shape == (b, k) and got.dtype == torch.float32 and got.is_cuda
    assert torch.equal(got, hellinger_strip_ref(rb, r))


@pytest.mark.parametrize("m,n", [(1, 1), (10, 199_210), (3, 513), (64, 4099)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aggregate_kernel_matches_plain(cuda, m, n, dtype):
    g = torch.Generator().manual_seed(m + n)
    x = torch.randn(m, n, generator=g).to(dtype).to(cuda)
    w = (torch.rand(m, generator=g) * (torch.rand(m, generator=g) > 0.3)).to(cuda)
    before = masked_weighted_sum.launches
    got = masked_weighted_sum(x, w)
    torch.cuda.synchronize()
    assert masked_weighted_sum.launches == before + 1
    assert got.shape == (n,) and got.dtype == torch.float32 and got.is_cuda
    assert torch.equal(got, masked_weighted_sum_ref(x, w))


def test_wrappers_reject_mixed_devices(cuda):
    with pytest.raises(ValueError):
        hellinger_strip(torch.rand(4, 3, device=cuda), torch.rand(4, 3))
    with pytest.raises(ValueError):
        masked_weighted_sum(torch.rand(2, 5, device=cuda), torch.rand(2))


def test_engine_on_card_matches_cpu(cuda):
    """The default draws come from host generators, so one seed gives the
    same indices on either device; the rounds then differ only by fp32
    summation order (cuBLAS vs the CPU), hence atol 1e-4 on params."""
    train = make_classification(800, n_features=64, n_classes=10, seed=0)
    test = make_classification(200, n_features=64, n_classes=10, seed=1)
    cfg = FLConfig(n_clients=12, m=4, rounds=3, strategy_kwargs={"J": 3}, hidden=(16,),
                   eval_samples=16, eval_every=1, target_hd=0.8, seed=0)
    k1, k2 = masked_weighted_sum.launches, hellinger_strip.launches
    gpu = make_engine(cfg, train, test, 10)
    res_gpu = list(gpu.rounds())
    assert masked_weighted_sum.launches == k1 + 3 and hellinger_strip.launches == k2 + 1
    cpu = make_engine(cfg, train, test, 10, device="cpu")
    res_cpu = list(cpu.rounds())
    assert [r.selected for r in res_gpu] == [r.selected for r in res_cpu]
    np.testing.assert_array_equal(gpu.strategy.labels, cpu.strategy.labels)
    np.testing.assert_allclose(gpu.params.cpu().numpy(), cpu.params.numpy(), atol=1e-4)
    for a, b in zip(res_gpu, res_cpu):
        assert abs(a.test_acc - b.test_acc) <= 1.0 / len(test.y)


@pytest.mark.parametrize("b,s,h,kv,d,window,is_global,dtype", [
    (80, 64, 32, 32, 80, 0, 1.0, torch.float32),      # the LM path's local SGD
    (4, 2048, 32, 32, 80, 0, 1.0, torch.float32),
    (4, 2048, 32, 32, 80, 0, 1.0, torch.bfloat16),
    (2, 1024, 8, 2, 128, 256, 0.0, torch.float32),    # GQA, sliding window
    (3, 77, 6, 3, 16, 9, 0.0, torch.bfloat16),        # ragged S, D below a tile
    (1, 100, 2, 1, 256, 0, 1.0, torch.float32),       # the largest D
    (80, 64, 32, 32, 80, 0, 1.0, torch.bfloat16),     # the local-SGD shape in bf16
    (80, 64, 25, 5, 64, 1024, 0.0, torch.float32),    # hymba's local SGD (GQA group 5)
    (2, 1, 4, 2, 64, 0, 1.0, torch.float32),          # S = 1
    (2, 65, 4, 2, 64, 0, 1.0, torch.float32),         # S = 65, across a tile edge
    (2, 70, 4, 2, 20, 0, 1.0, torch.float32),         # D = 20: padded to the MMA depth
    (2, 70, 4, 2, 40, 0, 1.0, torch.bfloat16),        # D = 40: padded to 48 in bf16
    (2, 70, 4, 2, 3, 0, 1.0, torch.float32),          # D = 3: rows not 16-byte aligned
    (2, 70, 4, 2, 3, 0, 1.0, torch.bfloat16),         # D = 3 in bf16: element copies
])
def test_flash_attention_kernels_match_plain(cuda, b, s, h, kv, d, window, is_global, dtype):
    g = torch.Generator().manual_seed(b * s + h * d)
    q, k, v = (torch.randn(b, s, n, d, generator=g).to(dtype).to(cuda) for n in (h, kv, kv))
    do = torch.randn(b, s, h, d, generator=g).to(dtype).to(cuda)
    _check_flash_against_plain(q, k, v, do, window, is_global)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_reads_fused_qkv_views(cuda, dtype):
    """q, k and v as strided views of one (B, S, H + 2 KV, D) tensor."""
    b, s, h, kv, d = 2, 100, 6, 2, 80
    g = torch.Generator().manual_seed(7)
    qkv = torch.randn(b, s, h + 2 * kv, d, generator=g).to(dtype).to(cuda)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
    assert not q.is_contiguous() and not k.is_contiguous()
    do = torch.randn(b, s, h, d, generator=g).to(dtype).to(cuda)
    _check_flash_against_plain(q, k, v, do, 0, 1.0)


def _check_flash_against_plain(q, k, v, do, window, is_global):
    dtype = q.dtype
    before = (flash_attention_forward.launches, flash_attention_backward.launches)
    o, lse = flash_attention_forward(q, k, v, window, is_global)
    grads = flash_attention_backward(q, k, v, o, lse, do, window, is_global)
    torch.cuda.synchronize()
    assert (flash_attention_forward.launches, flash_attention_backward.launches) == (
        before[0] + 1, before[1] + 1)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o_ref, lse_ref = attention_ref(*leaves, window, is_global)
    want = torch.autograd.grad(o_ref, leaves, do)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    for got, ref in [(o, o_ref), (lse, lse_ref), *zip(grads, want)]:
        assert got.shape == ref.shape and got.dtype == ref.dtype
        limit = tol * max(1.0, ref.float().abs().max().item())
        assert (got.float() - ref.float()).abs().max().item() <= limit


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_is_deterministic(cuda, dtype):
    """No atomics: two launches give the same bits in O, L and every gradient."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(3, 300, 10, 64, generator=g).to(dtype).to(cuda)
    k, v = (torch.randn(3, 300, 2, 64, generator=g).to(dtype).to(cuda) for _ in range(2))
    do = torch.randn(3, 300, 10, 64, generator=g).to(dtype).to(cuda)
    runs = []
    for _ in range(2):
        o, lse = flash_attention_forward(q, k, v, 128, 0.0)
        runs.append((o, lse, *flash_attention_backward(q, k, v, o, lse, do, 128, 0.0)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_flash_attention_rejects_non_unit_d_stride(cuda):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 16, 2, 8, generator=g).to(cuda) for _ in range(3))
    before = flash_attention_forward.launches
    with pytest.raises(ValueError, match="unit stride on D"):
        flash_attention_forward(q[..., ::2], k[..., ::2], v[..., ::2])
    with pytest.raises(ValueError, match="unit stride on D"):
        flash_attention(q, k.transpose(1, 3).contiguous().transpose(1, 3), v)
    assert flash_attention_forward.launches == before


def test_flash_attention_autograd_runs_both_kernels(cuda):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 50, 4, 80, generator=g).to(cuda).requires_grad_(True)
               for _ in range(3))
    before = (flash_attention_forward.launches, flash_attention_backward.launches)
    flash_attention(q, k, v).square().sum().backward()
    assert (flash_attention_forward.launches, flash_attention_backward.launches) == (
        before[0] + 1, before[1] + 1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


def test_lm_engine_on_card_launches_attention_kernels(cuda):
    """One round of the LM micro configuration on the card: K3 runs forward
    in the poll, the local steps and both evaluations, and backward in the
    local steps; the CPU run from the same draws selects the same clients."""
    train = make_token_stream(48, 16, 32, seed=0)
    test = make_token_stream(16, 16, 32, seed=1)
    cfg = FLConfig(task="lm", n_clients=8, m=3, rounds=1, strategy_kwargs={"J": 2},
                   batch_size=4, eval_samples=4, eval_every=1, target_hd=0.8, max_steps_cap=3,
                   seed=0, task_kwargs={
                       "model": "stablelm-3b", "hist_bins": 16,
                       "overrides": {"d_model": 32, "n_heads": 2, "n_kv_heads": 2,
                                     "head_dim": 16, "d_ff": 64, "vocab": 32,
                                     "loss_chunk": 16, "attn_chunk": 16, "remat": False}})
    before = (flash_attention_forward.launches, flash_attention_backward.launches)
    gpu = make_engine(cfg, train, test, 32)
    res_gpu = list(gpu.rounds())
    layers, steps = gpu.task.model_cfg.n_layers, gpu.max_steps
    assert (flash_attention_forward.launches - before[0],
            flash_attention_backward.launches - before[1]) == (layers * (3 + steps),
                                                               layers * steps)
    res_cpu = list(make_engine(cfg, train, test, 32, device="cpu").rounds())
    assert [r.selected for r in res_gpu] == [r.selected for r in res_cpu]
    assert abs(res_gpu[0].metrics["ppl"] - res_cpu[0].metrics["ppl"]) <= 1e-4



def _scan_inputs(b, s, d, n, groups, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(b, s, d, generator=g) * 0.5).to(dtype).to(device)
    dt = (torch.randn(b, s, d, generator=g) * 0.02 + 0.05).abs().to(dtype).to(device)
    bm, cm = (torch.randn(b, s, n, generator=g).to(dtype).to(device) for _ in range(2))
    wshape = (d, n) if groups == 0 else (groups, d, n)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32)).expand(*wshape)
    a_log = (a_log + 0.1 * torch.randn(*wshape, generator=g)).to(device)
    d_skip = (1 + 0.1 * torch.randn(*wshape[:-1], generator=g)).to(device)
    return x, dt, bm, cm, a_log, d_skip


@pytest.mark.parametrize("b,s,d,n,groups,dtype", [
    (80, 64, 1600, 16, 10, torch.float32),     # hymba's local SGD: 10 clients x 8 sequences
    (3, 100, 130, 16, 0, torch.float32),       # ragged D and S, shared weights
    (2, 37, 10, 8, 2, torch.float32),          # N below 16, one row a group
    (4, 300, 200, 16, 0, torch.bfloat16),
])
def test_mamba_scan_kernels_match_plain(cuda, b, s, d, n, groups, dtype):
    inputs = _scan_inputs(b, s, d, n, groups, dtype, cuda, b * s + d)
    dy = torch.randn(b, s, d, generator=torch.Generator().manual_seed(1)).to(dtype).to(cuda)
    before = (mamba_scan_forward.launches, mamba_scan_backward.launches)
    y, ckpt = mamba_scan_forward(*inputs, checkpoints=True)
    grads = mamba_scan_backward(*inputs, ckpt, dy)
    torch.cuda.synchronize()
    assert (mamba_scan_forward.launches, mamba_scan_backward.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(mamba_scan_forward(*inputs), y)  # no checkpoints: the same values
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    y_ref = mamba_scan_ref(*leaves)
    want = torch.autograd.grad(y_ref, leaves, dy)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    for got, ref in [(y, y_ref), *zip(grads, want)]:
        assert got.shape == ref.shape and got.dtype == ref.dtype
        limit = tol * max(1.0, ref.float().abs().max().item())
        assert (got.float() - ref.float()).abs().max().item() <= limit


def test_mamba_scan_autograd_runs_both_kernels(cuda):
    leaves = [t.requires_grad_(True) for t in _scan_inputs(4, 50, 96, 16, 2, torch.float32,
                                                           cuda, 0)]
    before = (mamba_scan_forward.launches, mamba_scan_backward.launches)
    mamba_scan(*leaves).square().sum().backward()
    assert (mamba_scan_forward.launches, mamba_scan_backward.launches) == (
        before[0] + 1, before[1] + 1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)
    with torch.no_grad():  # no gradient wanted: the forward alone, no checkpoints
        mamba_scan(*leaves)
    assert mamba_scan_backward.launches == before[1] + 1
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan(leaves[0].transpose(1, 2).contiguous().transpose(1, 2), *leaves[1:])


def test_hymba_engine_on_card_launches_both_kernels(cuda):
    """One round of the hymba micro configuration on the card: K3 and K4 run
    forward in the poll, the local steps and both evaluations, and backward
    in the local steps; the CPU run from the same draws selects the same
    clients."""
    train = make_token_stream(48, 16, 32, seed=0)
    test = make_token_stream(16, 16, 32, seed=1)
    cfg = FLConfig(task="lm", n_clients=8, m=3, rounds=1, strategy_kwargs={"J": 2},
                   batch_size=4, eval_samples=4, eval_every=1, target_hd=0.8, max_steps_cap=3,
                   seed=0, task_kwargs={
                       "model": "hymba-1.5b", "hist_bins": 16,
                       "overrides": {"d_model": 32, "n_heads": 4, "n_kv_heads": 2,
                                     "head_dim": 16, "d_ff": 64, "vocab": 32,
                                     "loss_chunk": 16, "attn_chunk": 16, "remat": False,
                                     "sliding_window": 8}})
    counters = (flash_attention_forward, flash_attention_backward, mamba_scan_forward,
                mamba_scan_backward)
    before = [c.launches for c in counters]
    gpu = make_engine(cfg, train, test, 32)
    res_gpu = list(gpu.rounds())
    layers, steps = gpu.task.model_cfg.n_layers, gpu.max_steps
    assert [c.launches - b for c, b in zip(counters, before)] == [
        layers * (3 + steps), layers * steps] * 2
    res_cpu = list(make_engine(cfg, train, test, 32, device="cpu").rounds())
    assert [r.selected for r in res_gpu] == [r.selected for r in res_cpu]
    assert abs(res_gpu[0].metrics["ppl"] - res_cpu[0].metrics["ppl"]) <= 1e-4
