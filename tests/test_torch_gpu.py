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
another order than the plain version's loop.  A population engine holds
no per-client stack on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.hellinger import _sqrt_rows, hellinger_blocked  # noqa: E402
from repro_torch.data import make_classification, make_token_stream  # noqa: E402
from repro_torch.engine import FLConfig, make_engine  # noqa: E402
from repro_torch.engine.draws import TorchDraws  # noqa: E402
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


def _check_strip(rb, r):
    before = hellinger_strip.launches
    got = hellinger_strip(rb, r)
    torch.cuda.synchronize()
    assert hellinger_strip.launches == before + 1
    assert got.shape == (rb.shape[0], r.shape[0]) and got.dtype == torch.float32 and got.is_cuda
    assert torch.equal(got, hellinger_strip_ref(rb, r))


@pytest.mark.parametrize("b,k,c", [(1, 1, 1), (100, 100, 10), (37, 70, 130),
                                   (300, 1000, 10), (33, 65, 32), (64, 64, 33)])
def test_hellinger_kernel_matches_plain(cuda, b, k, c):
    g = torch.Generator().manual_seed(b * k + c)
    _check_strip(_panel(b, c, g).to(cuda), _panel(k, c, g).to(cuda))


# k % 4 = 0 takes the 16-byte stores, 1..3 the masked 4-byte ones; b off
# the tile rows; C = 64, 65 and 130 take several 32-class chunks.  Strips
# of fewer 64 x 128 tiles than SMs take 32-row tiles, the last two (132
# and 201 such tiles on 132 SMs) 64-row ones
@pytest.mark.parametrize("b,k", [(100, 100), (70, 301), (129, 302), (65, 303),
                                 (128, 66 * 128), (129, 66 * 128 + 1)])
@pytest.mark.parametrize("c", [1, 10, 64, 65, 130])
def test_hellinger_kernel_store_paths_and_chunks(cuda, b, k, c):
    g = torch.Generator().manual_seed(b + k * c)
    _check_strip(_panel(b, c, g).to(cuda), _panel(k, c, g).to(cuda))


@pytest.mark.parametrize("c", [10, 65])
def test_hellinger_kernel_reads_a_misaligned_row_slice(cuda, c):
    """rb = r[7:300], as hellinger_blocked cuts it at block = 7: its base is
    7 * C floats past r's, not 16-byte aligned for these C."""
    g = torch.Generator().manual_seed(c)
    r = _panel(300, c, g).to(cuda)
    rb = r[7:300]
    assert rb.is_contiguous() and rb.data_ptr() % 16 != 0
    _check_strip(rb, r)


def test_hellinger_blocked_on_card_equals_cpu(cuda):
    """Strips of 7 rows (row slices r[i0:i0 + 7], mostly misaligned) give
    the card's plain version of the whole matrix bit for bit.  Against the
    CPU run they agree within one ulp, not bit for bit: PyTorch's
    vectorised fp32 sqrt on the CPU is not correctly rounded (the card's,
    and IEEE sqrtf in the kernel, are)."""
    rng = np.random.default_rng(0)
    h = rng.dirichlet(np.ones(10) * 0.5, size=300)
    got = hellinger_blocked(h, block=7, device=cuda)
    r = torch.from_numpy(_sqrt_rows(h)).to(cuda)
    want = hellinger_strip_ref(r, r).cpu().numpy()
    np.fill_diagonal(want, 0.0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_max_ulp(got, hellinger_blocked(h, block=7, device="cpu"), maxulp=1)


def _check_reduce(x, w):
    before = masked_weighted_sum.launches
    got = masked_weighted_sum(x, w)
    torch.cuda.synchronize()
    assert masked_weighted_sum.launches == before + 1
    assert got.shape == (x.shape[1],) and got.dtype == torch.float32 and got.is_cuda
    assert torch.equal(got, masked_weighted_sum_ref(x, w))


@pytest.mark.parametrize("m,n", [(1, 1), (10, 199_210), (3, 513), (64, 4099)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aggregate_kernel_matches_plain(cuda, m, n, dtype):
    g = torch.Generator().manual_seed(m + n)
    x = torch.randn(m, n, generator=g).to(dtype).to(cuda)
    w = (torch.rand(m, generator=g) * (torch.rand(m, generator=g) > 0.3)).to(cuda)
    _check_reduce(x, w)


# n = 600,000 + r: wide enough for every load width under the two-blocks-an-SM
# cap, and n % 8 = r picks the width (16, 8 or 4 bytes, or one element); m
# a part of one 16-row batch, whole batches, and whole batches and a part;
# rows 1.. of an (m + 1, n) tensor start 4- or 8-byte aligned
@pytest.mark.parametrize("r", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("m", [1, 9, 64, 65])
@pytest.mark.parametrize("offset_row", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aggregate_kernel_load_widths(cuda, r, m, offset_row, dtype):
    n = 600_000 + r
    g = torch.Generator().manual_seed(m * 10 + r)
    full = torch.randn(m + offset_row, n, generator=g).to(dtype).to(cuda)
    x = full[1:] if offset_row else full
    w = (torch.rand(m, generator=g) * (torch.rand(m, generator=g) > 0.3)).to(cuda)
    assert x.is_contiguous()
    _check_reduce(x, w)


def test_wrappers_reject_mixed_devices(cuda):
    with pytest.raises(ValueError):
        hellinger_strip(torch.rand(4, 3, device=cuda), torch.rand(4, 3))
    with pytest.raises(ValueError):
        masked_weighted_sum(torch.rand(2, 5, device=cuda), torch.rand(2))


@pytest.mark.parametrize("m,n", [(10, 199_210), (4, 4099)])
def test_fednova_and_feddyn_on_the_kernel_equal_their_cpu_plain_versions(cuda, m, n):
    """One K1 launch a rule, the cohort left as it was; against the same rule
    on the CPU (the plain reduce) within a few fp32 ulps (rtol 1e-6): the
    few-element weight sums are taken in another order on the card, and
    FedNova scales that by τ_eff."""
    from repro_torch.federated.aggregation import feddyn_server, feddyn_update_h, fednova

    g = torch.Generator().manual_seed(m * n)
    x, gp, h = torch.randn(m, n, generator=g), torch.randn(n, generator=g), torch.randn(n, generator=g)
    w = torch.rand(m, generator=g) + 0.1
    w, taus = w / w.sum(), torch.randint(0, 9, (m,), generator=g).to(torch.float32)
    xc, gpc, hc, wc, tc = (t.to(cuda) for t in (x, gp, h, w, taus))
    before = masked_weighted_sum.launches
    nova = fednova(xc, gpc, wc, tc)
    theta, mean = feddyn_server(xc, wc, hc, 0.1)
    h_new = feddyn_update_h(hc, mean, gpc, 0.1, m / 100)
    torch.cuda.synchronize()
    assert masked_weighted_sum.launches == before + 2
    assert torch.equal(xc.cpu(), x)
    want = (fednova(x, gp, w, taus), *feddyn_server(x, w, h, 0.1))
    want += (feddyn_update_h(h, want[2], gp, 0.1, m / 100),)
    for got, ref in zip((nova, theta, mean, h_new), want):
        assert got.is_cuda and got.shape == (n,)
        np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,k1_per_round", [("fedavg", 1), ("fednova", 1), ("feddyn", 1),
                                               ("fedprox", 1), ("trimmed_mean", 0),
                                               ("coordinate_median", 0)])
def test_baseline_engines_on_card_match_cpu(cuda, name, k1_per_round):
    """The paper's baselines (random selection, so K2 never launches) and the
    robust aggregators: one K1 launch a round where the rule reduces, none
    where it sorts, and the card's run equals the CPU's as in
    ``test_engine_on_card_matches_cpu``."""
    from repro_torch.engine import get_preset

    train = make_classification(800, n_features=64, n_classes=10, seed=0)
    test = make_classification(200, n_features=64, n_classes=10, seed=1)
    kw = dict(n_clients=12, m=4, rounds=3, hidden=(16,), eval_samples=16, eval_every=1,
              target_hd=0.8, seed=0)
    if name in ("trimmed_mean", "coordinate_median"):
        cfg = FLConfig(strategy="random", aggregator=name, **kw)
    else:
        cfg = get_preset(name).make_config(**kw)
    k1, k2 = masked_weighted_sum.launches, hellinger_strip.launches
    gpu = make_engine(cfg, train, test, 10)
    res_gpu = list(gpu.rounds())
    assert masked_weighted_sum.launches == k1 + 3 * k1_per_round
    assert hellinger_strip.launches == k2
    cpu = make_engine(cfg, train, test, 10, device="cpu")
    res_cpu = list(cpu.rounds())
    assert [r.selected for r in res_gpu] == [r.selected for r in res_cpu]
    np.testing.assert_allclose(gpu.params.cpu().numpy(), cpu.params.numpy(), atol=1e-4)
    if gpu.h_clients is not None:
        np.testing.assert_allclose(gpu.h_clients.cpu().numpy(), cpu.h_clients.numpy(), atol=1e-4)


def test_engine_on_card_matches_cpu(cuda):
    """The default draws hash (seed, round, client, position) to the same
    bits on either device, so one seed gives the same indices; the rounds
    then differ only by fp32 summation order (cuBLAS vs the CPU), hence
    atol 1e-4 on params."""
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


def _fused_case(**kw):
    train = make_classification(800, n_features=64, n_classes=10, seed=0)
    test = make_classification(200, n_features=64, n_classes=10, seed=1)
    # chunks of 3: round 0; rounds 1-3 run eagerly, then are captured; 4-6 and
    # 7-9 replay the graph; 10
    cfg = FLConfig(n_clients=12, m=4, rounds=11, strategy_kwargs={"J": 3}, hidden=(16,),
                   eval_samples=16, eval_every=3, target_hd=0.8, seed=0, backend="compiled",
                   **kw)
    return cfg, train, test


@pytest.mark.parametrize("compress_bits", [0, 8])
def test_fused_replays_match_the_eager_rounds(cuda, compress_bits):
    """The captured chunk's replays give the eager compiled rounds' selections
    and parameters (the same draws; the same kernels, launched from a
    graph), and the CPU run's selections; K1 launches once a round, counted
    at replay: 1 + 3 eager launches, then 3 for each of 2 replays, and 1."""
    cfg, train, test = _fused_case(fuse_rounds=3, compress_bits=compress_bits)
    masked_weighted_sum.launches = masked_weighted_sum.captured = 0
    fused = make_engine(cfg, train, test, 10)
    res = list(fused.rounds())
    assert fused.graph_replays == {1: 1, 3: 2} and fused.graph_launches == {1: 1, 3: 3}
    assert masked_weighted_sum.captured == 4
    assert masked_weighted_sum.launches == 1 + 3 and fused.replayed_launches() == 1 + 3 * 2
    assert masked_weighted_sum.launches + fused.replayed_launches() == cfg.rounds
    eager = make_engine(FLConfig.from_dict({**cfg.to_dict(), "fuse_rounds": 0}), train, test, 10)
    res_eager = list(eager.rounds())
    assert [r.selected for r in res] == [r.selected for r in res_eager]
    np.testing.assert_allclose(fused.params.cpu().numpy(), eager.params.cpu().numpy(),
                               atol=1e-5)
    if compress_bits:
        assert fused.last_quant_error == pytest.approx(eager.last_quant_error, rel=1e-4)
    else:  # the CPU draws the same indices and noise; compression's uniforms come from the card
        cpu = make_engine(cfg, train, test, 10, device="cpu")
        assert [r.selected for r in cpu.rounds()] == [r.selected for r in res]
        np.testing.assert_allclose(fused.params.cpu().numpy(), cpu.params.numpy(), atol=1e-4)


@pytest.mark.parametrize("m,n", [(13, 199_210), (10, 4099), (3, 600_003)])
@pytest.mark.parametrize("nan_weight", [0.0, 0.25])
def test_aggregate_kernel_with_nan_rows_matches_plain(cuda, m, n, nan_weight):
    """A NaN row (the fault axis's undefended ``nan_update``) at weight > 0
    makes every column NaN; at weight 0 the plain version's 0 · NaN = NaN
    too: the kernel gives the plain version's result either way."""
    g = torch.Generator().manual_seed(m * n)
    x = torch.randn(m, n, generator=g)
    x[1] = float("nan")
    x[m - 1, : n // 2] = float("inf")
    w = torch.rand(m, generator=g)
    w[1] = nan_weight
    w = (w / w.sum()).to(cuda)
    x = x.to(cuda)
    before = masked_weighted_sum.launches
    got = masked_weighted_sum(x, w)
    want = masked_weighted_sum_ref(x, w)
    torch.cuda.synchronize()
    assert masked_weighted_sum.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(got).all()


def test_fused_with_systems_and_faults_on_card_matches_cpu(cuda):
    """The fused chunk with both axes (availability, deadline,
    over-selection, injection, the validation gate and quarantine inside a
    captured graph) on the card against the same run on the CPU: the same
    survivors, drops and fault counts every round, params within 1e-4."""
    cfg, train, test = _fused_case(
        fuse_rounds=3,
        systems={"profile": "zipf_compute", "availability": "markov",
                 "availability_kwargs": {"p_drop": 0.4, "p_join": 0.4}, "deadline_s": 2.0,
                 "over_select": 1.5, "jitter_sigma": 0.1},
        faults={"rate": 0.3, "models": ["sign_flip", "nan_update", "truncated_upload"],
                "defense": "validate"})
    masked_weighted_sum.launches = masked_weighted_sum.captured = 0
    fused = make_engine(cfg, train, test, 10)
    res = list(fused.rounds())
    assert fused.graph_replays == {1: 1, 3: 2}
    assert masked_weighted_sum.launches + fused.replayed_launches() == cfg.rounds
    cpu = make_engine(cfg, train, test, 10, device="cpu")
    res_cpu = list(cpu.rounds())
    for a, b in zip(res, res_cpu, strict=True):
        assert (a.selected, a.n_dropped, a.sim_time, a.n_faulty, a.n_quarantined) == (
            b.selected, b.n_dropped, b.sim_time, b.n_faulty, b.n_quarantined), a.round
        assert a.comm_mb == pytest.approx(b.comm_mb)
    assert sum(r.n_faulty for r in res) > 0 and sum(r.n_dropped for r in res) > 0
    assert torch.isfinite(fused.params).all()
    np.testing.assert_allclose(fused.params.cpu().numpy(), cpu.params.numpy(), atol=1e-4)


def test_fused_params_survive_later_replays(cuda):
    """A replay overwrites the graph's output buffers: ``engine.params`` is
    a copy, so a reference held across later chunks keeps its values."""
    cfg, train, test = _fused_case(fuse_rounds=3)
    engine = make_engine(cfg, train, test, 10)
    list(engine.rounds(4))                  # rounds 0-3: the capture
    held, values = engine.params, engine.params.clone()
    out = engine._graphs[3].out[0]
    list(engine.rounds(3))                  # rounds 4-6: a replay
    assert engine.graph_replays[3] == 1 and held.data_ptr() != out.data_ptr()
    assert engine.params.data_ptr() != out.data_ptr()
    assert torch.equal(held, values) and not torch.equal(engine.params, held)


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


@pytest.mark.parametrize("b,s,h,kv", [
    (4, 128, 128, 128),     # deepseek-v3's MLA prefill: 128 + 64 dims for q and k
    (2, 256, 16, 16),       # and a backward through the whole DMAX-256 template
    (2, 70, 4, 4),          # ragged S
])
def test_flash_attention_d192_bf16_matches_plain(cuda, b, s, h, kv):
    """D = 192 in bf16, the DMAX-256 template, as MLA runs it: its values
    zero-padded from 128 dims, so the last 64 columns of O come out zero."""
    g = torch.Generator().manual_seed(b * s + h)
    q, k = (torch.randn(b, s, n, 192, generator=g).to(torch.bfloat16).to(cuda) for n in (h, kv))
    v = torch.nn.functional.pad(torch.randn(b, s, kv, 128, generator=g), (0, 64))
    v = v.to(torch.bfloat16).to(cuda)
    do = torch.randn(b, s, h, 192, generator=g).to(torch.bfloat16).to(cuda)
    _check_flash_against_plain(q, k, v, do, 0, 1.0)
    o, _ = flash_attention_forward(q, k, v)
    assert not o[..., 128:].any()


def test_mla_attention_on_card_matches_cpu(cuda):
    """deepseek-v3's reduced MLA block in fp32 through K3 (padded values)
    against the plain version on the CPU, output and gradients."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    from repro_torch.models.common import rope_table

    cfg = get_config("deepseek-v3-671b", reduced=True)
    p = attention.init_mla(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 96, cfg.d_model, generator=torch.Generator().manual_seed(1))
    outs = []
    for dev in ("cpu", cuda):
        leaves = {k: v.to(dev).requires_grad_(True) for k, v in p.items()}
        xd = x.to(dev).requires_grad_(True)
        sin, cos = rope_table(96, cfg.qk_rope_head_dim, cfg.rope_theta, dev)
        before = flash_attention_forward.launches
        out, _ = attention.mla_attention(leaves, cfg, xd, sin, cos)
        grads = torch.autograd.grad(out.square().sum(), [xd, *leaves.values()])
        assert flash_attention_forward.launches == before + (dev == cuda)
        outs.append([out.detach().cpu(), *(gr.cpu() for gr in grads)])
    for a, b in zip(*outs):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item())


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
    (3, 45, 70, 5, 3, torch.float32),          # N = 5: a lane with one live state
    (2, 19, 33, 1, 0, torch.float32),          # N = 1: three lanes of a channel idle
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


@pytest.mark.parametrize("b,s,d,n,groups", [
    (80, 64, 1600, 16, 10),  # hymba's local SGD
    (3, 100, 130, 5, 0),     # ragged D and S, a partly filled lane
])
def test_mamba_scan_is_deterministic(cuda, b, s, d, n, groups):
    """No atomics: two launches give the same bits in y, the checkpoints and
    all six gradients."""
    inputs = _scan_inputs(b, s, d, n, groups, torch.float32, cuda, b + s + d)
    dy = torch.randn(b, s, d, generator=torch.Generator().manual_seed(2)).to(cuda)
    runs = []
    for _ in range(2):
        y, ckpt = mamba_scan_forward(*inputs, checkpoints=True)
        runs.append((y, ckpt, *mamba_scan_backward(*inputs, ckpt, dy)))
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


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


@pytest.mark.parametrize("kw", [{}, {"backend": "compiled"},
                                {"backend": "compiled", "fuse_rounds": 3},
                                {"backend": "compiled", "fuse_rounds": 3, "compress_bits": 8}],
                         ids=["host", "compiled", "fused", "fused_int8"])
def test_deleted_engine_hands_back_its_device_memory(cuda, kw):
    """An engine's tensors, a fused engine's captured graphs and their
    buffers among them, are freed with the engine: two engines built, run
    and deleted in turn leave no more allocated than before the first (the
    paper's users build one engine per method and seed).  The last fused
    engine to go also returns cuBLAS's per-stream workspaces, the main
    stream's among them, so the level may fall below the one before."""
    import gc

    cfg, train, test = _fused_case()
    cfg = FLConfig.from_dict({**cfg.to_dict(), "backend": "host", **kw})
    torch.cuda.synchronize()
    gc.collect()
    before = torch.cuda.memory_allocated()
    for _ in range(2):
        engine = make_engine(cfg, train, test, 10)
        list(engine.rounds())
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() > before
        del engine
        gc.collect()
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() <= before


def test_torch_draws_are_the_same_on_cpu_and_card(cuda):
    """The counter hash gives the same bits on either device: the same rows,
    uniforms, Gumbel noise and permutations."""
    mask = (torch.arange(50)[None, :] < torch.tensor([50, 7, 1, 33, 0, 20])[:, None]).float()
    probs = mask / torch.clamp(mask.sum(-1, keepdim=True), min=1e-9)
    cpu, card = TorchDraws(3, "cpu"), TorchDraws(3, "cuda")
    card.bind_rows(probs)
    for rnd in (0, 1, 149):
        assert torch.equal(cpu.poll_indices(rnd, probs, 64),
                           card.poll_indices(rnd, probs, 64).cpu())
        clients = np.array([5, 0, 3])
        assert torch.equal(cpu.batch_indices(rnd, clients, probs[clients], 4, 8),
                           card.batch_indices(rnd, clients, probs[clients], 4, 8).cpu())
        assert torch.equal(cpu.client_batch_indices(rnd, probs, 4, 8),
                           card.client_batch_indices(rnd, probs, 4, 8).cpu())
        for kind in ("uniform", "gumbel", "permutations"):
            for a, b in zip(cpu.selection_noise(rnd, kind, 100, 10),
                            card.selection_noise(rnd, kind, 100, 10)):
                assert b.is_cuda and torch.equal(a, b.cpu()), kind


def test_xlstm_micro_round_on_card_matches_cpu(cuda):
    """One round of the 4-layer xlstm micro configuration (three mLSTM
    layers and one sLSTM layer, two chunks of 64 over 128 tokens) on the
    card and on the CPU from the same draws; K1 launches once and K2 once.
    One local step and the perplexity within 1e-4 relative: xLSTM's
    training moves fp32 noise further than the attention models'
    (``scripts/xlstm_sensitivity.py``)."""
    train = make_token_stream(48, 128, 32, seed=0)
    test = make_token_stream(16, 128, 32, seed=1)
    cfg = FLConfig(task="lm", n_clients=8, m=3, rounds=1, strategy_kwargs={"J": 2},
                   batch_size=4, eval_samples=4, eval_every=1, target_hd=0.8, max_steps_cap=1,
                   seed=0, task_kwargs={
                       "model": "xlstm-125m", "hist_bins": 16,
                       "overrides": {"n_layers": 4, "d_model": 32, "vocab": 32,
                                     "loss_chunk": 16}})
    k1, k2 = masked_weighted_sum.launches, hellinger_strip.launches
    gpu = make_engine(cfg, train, test, 32)
    res_gpu = list(gpu.rounds())
    assert (masked_weighted_sum.launches - k1, hellinger_strip.launches - k2) == (1, 1)
    cpu = make_engine(cfg, train, test, 32, device="cpu")
    res_cpu = list(cpu.rounds())
    assert [r.selected for r in res_gpu] == [r.selected for r in res_cpu]
    ppl = res_cpu[0].metrics["ppl"]
    assert abs(res_gpu[0].metrics["ppl"] - ppl) <= 1e-4 * ppl
    np.testing.assert_allclose(gpu.params.cpu().numpy(), cpu.params.numpy(), atol=1e-4)


def _async_case(**kw):
    train = make_classification(800, n_features=64, n_classes=10, seed=0)
    test = make_classification(200, n_features=64, n_classes=10, seed=1)
    cfg = FLConfig(n_clients=12, m=4, rounds=8, hidden=(16,), eval_samples=16, eval_every=2,
                   target_hd=0.8, seed=0, strategy_kwargs={"J": 3},
                   systems={"profile": "mobile_mix", "availability": "markov",
                            "jitter_sigma": 0.1},
                   async_mode={"buffer_k": 3, "concurrency": 8, "staleness": "polynomial"},
                   **kw)
    return cfg, train, test


@pytest.mark.parametrize("backend", ["host", "compiled"])
def test_async_engine_on_card_launches_k1_per_update_and_matches_cpu(cuda, backend):
    """The async runtime on the card: K1 once a step that applies an update
    (the final params version), over at most buffer_k kept deltas; the same
    survivors, versions and staleness as on the CPU from the same draws,
    params within 1e-4."""
    cfg, train, test = _async_case(backend=backend)
    k1 = masked_weighted_sum.launches
    gpu = make_engine(cfg, train, test, 10)
    res_gpu = list(gpu.rounds())
    assert masked_weighted_sum.launches - k1 == res_gpu[-1].params_version > 0
    cpu = make_engine(cfg, train, test, 10, device="cpu")
    res_cpu = list(cpu.rounds())
    fields = ("selected", "params_version", "staleness", "n_dropped", "sim_time")
    assert [tuple(getattr(r, f) for f in fields) for r in res_gpu] == \
        [tuple(getattr(r, f) for f in fields) for r in res_cpu]
    np.testing.assert_allclose(gpu.params.cpu().numpy(), cpu.params.numpy(), atol=1e-4)


def test_async_kill_and_resume_on_card_is_bit_identical(cuda, tmp_path):
    """A run killed mid-buffer on the card resumes to the uninterrupted
    run's bits: the ledger's rows load back onto the card."""
    cfg, train, test = _async_case()
    ref = make_engine(cfg, train, test, 10)
    ref_res = list(ref.rounds())
    killed = make_engine(cfg, train, test, 10)
    it = killed.rounds()
    pre = [next(it) for _ in range(4)]
    it.close()
    assert killed._n_inflight() > 0
    killed.save(str(tmp_path / "a.ckpt"))
    resumed = make_engine(cfg, train, test, 10)
    resumed.restore(str(tmp_path / "a.ckpt"))
    assert all(g.stacked.is_cuda for g in resumed._ledger)
    post = list(resumed.rounds())
    assert [(r.selected, r.params_version, r.sim_clock) for r in pre + post] == \
        [(r.selected, r.params_version, r.sim_clock) for r in ref_res]
    assert torch.equal(resumed.params, ref.params)


@pytest.mark.parametrize("compress_bits", [0, 8])
def test_fused_engine_restores_after_capturing_its_graphs(cuda, tmp_path, compress_bits):
    """A fused engine that has captured and replayed its chunk graphs
    restores an older checkpoint and reruns to the uninterrupted run's bits:
    each chunk copies ``engine.params`` into its graph's input buffer, and
    the quantization generator, registered with the graphs, takes its saved
    state."""
    from repro_torch.checkpoint import Checkpointer, CheckpointPolicy

    cfg, train, test = _fused_case()
    cfg = FLConfig.from_dict({**cfg.to_dict(), "backend": "compiled", "fuse_rounds": 2,
                              "rounds": 8, "eval_every": 100, "compress_bits": compress_bits})
    engine = make_engine(cfg, train, test, 10, checkpointer=Checkpointer(
        str(tmp_path / "ck"), CheckpointPolicy(every_rounds=2)))
    full = list(engine.rounds())
    assert sum(engine.graph_replays.values()) > 0
    want = engine.params.clone()
    engine.restore(str(tmp_path / "ck" / "round_00000004.ckpt"))
    again = list(engine.rounds())
    assert [r.selected for r in again] == [r.selected for r in full[4:]]
    assert torch.equal(engine.params, want)
    engine.close()


def test_serializer_loads_tensors_onto_the_card(cuda, tmp_path):
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    x = torch.randn(3, 1000, device="cuda")
    save_checkpoint(str(tmp_path / "x.ckpt"), {"x": x, "g": torch.Generator("cuda").get_state()})
    out, _ = load_checkpoint(str(tmp_path / "x.ckpt"),
                             like={"x": torch.empty(3, 1000, device="meta"),
                                   "g": torch.zeros(16, dtype=torch.uint8)}, device="cuda")
    assert out["x"].is_cuda and torch.equal(out["x"], x)


def _engine_bytes(cfg, train, test):
    """Device bytes an engine for ``cfg`` holds after construction, and the
    engine."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    engine = make_engine(cfg, train, test, 10)
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() - before, engine


def test_population_engine_holds_less_device_memory_than_flat(cuda):
    """At K = 10^4 a population engine keeps the packed stacks on the host:
    after construction it holds at least the flat engine's stacks (less 1
    MiB) fewer device bytes, and it still trains, on the card."""
    k = 10_000
    train = make_classification(16 * k, n_features=64, n_classes=10, seed=0)
    test = make_classification(500, n_features=64, n_classes=10, seed=1)
    cfg = FLConfig(n_clients=k, m=32, rounds=2, strategy="random", hidden=(64,),
                   eval_samples=8, target_hd=0.8, batch_size=16, local_epochs=2, lr=0.05)
    flat_bytes, flat = _engine_bytes(cfg, train, test)
    stack = flat.xs.nbytes + flat.ys.nbytes
    del flat
    pop_cfg = FLConfig.from_dict({**cfg.to_dict(), "population": {
        "n_shards": k // 64, "shards_per_round": 4, "j_shards": 3}})
    pop_bytes, engine = _engine_bytes(pop_cfg, train, test)
    assert engine.xs is None and engine.draws._rows is None
    assert flat_bytes - pop_bytes >= stack - 2**20, (flat_bytes, pop_bytes, stack)
    for r in engine.rounds():
        assert len(r.selected) == 32 and set(r.selected) <= set(engine._pop_members.tolist())
    assert engine.params.is_cuda and torch.isfinite(engine.params).all()


@pytest.mark.parametrize("k,block", [(1000, 7), (5000, 1024)])
def test_hellinger_blocked_pinned_copy_is_the_single_strip_build(cuda, k, block):
    """The double-buffered pinned copy-out gives the one-strip matrix bit for
    bit, and launches the strip kernel once a strip."""
    h = np.random.default_rng(k).dirichlet(np.ones(10) * 0.5, size=k)
    before = hellinger_strip.launches
    got = hellinger_blocked(h, block=block, device=cuda)
    assert hellinger_strip.launches == before + -(-k // block)
    np.testing.assert_array_equal(got, hellinger_blocked(h, block=k, device=cuda))


@pytest.mark.parametrize("b,s,d,n,groups,dtype", [
    (4, 128, 1600, 16, 0, torch.float32),   # hymba's serving prefill
    (4, 1280, 1600, 16, 0, torch.float32),
    (4, 100, 130, 5, 2, torch.float32),     # ragged D and S, a partly filled lane, groups
    (2, 37, 70, 16, 0, torch.bfloat16),
])
def test_mamba_scan_final_state_matches_plain(cuda, b, s, d, n, groups, dtype):
    """The forward's final-state output is the plain version's state after
    the last step, within the scan's fp32 tolerance, in the same launch as
    y (with and without checkpoints), and y is unchanged by it."""
    inputs = _scan_inputs(b, s, d, n, groups, dtype, cuda, b * s + n)
    before = mamba_scan_forward.launches
    y, h = mamba_scan_forward(*inputs, final_state=True)
    y2, ckpt, h2 = mamba_scan_forward(*inputs, checkpoints=True, final_state=True)
    torch.cuda.synchronize()
    assert mamba_scan_forward.launches == before + 2
    y_ref, h_ref = mamba_scan_ref(*inputs, final_state=True)
    assert h.shape == (b, d, n) and h.dtype == torch.float32 and ckpt.shape[0] == b
    assert torch.equal(y, mamba_scan_forward(*inputs)) and torch.equal(y, y2)
    assert torch.equal(h, h2)
    assert (h - h_ref).abs().max().item() <= 2e-5 * max(1.0, h_ref.abs().max().item())
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    assert (y.float() - y_ref.float()).abs().max().item() <= tol * max(
        1.0, y_ref.float().abs().max().item())


def test_k3_and_k4_count_captured_launches_apart(cuda):
    """A launch recorded into a CUDA graph counts in ``captured``, not in
    ``launches``, as K1's does; replays count nowhere."""
    q, k, v = (torch.randn(2, 64, h, 32, device=cuda) for h in (4, 2, 2))
    inputs = _scan_inputs(2, 40, 64, 16, 0, torch.float32, cuda, 3)
    flash_attention_forward(q, k, v)
    mamba_scan_forward(*inputs, final_state=True)   # warm up outside the capture
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    counts = lambda: (flash_attention_forward.launches, flash_attention_forward.captured,  # noqa: E731
                      mamba_scan_forward.launches, mamba_scan_forward.captured)
    before = counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        o, _ = flash_attention_forward(q, k, v)
        y, h = mamba_scan_forward(*inputs, final_state=True)
    torch.cuda.current_stream().wait_stream(stream)
    assert counts() == (before[0], before[1] + 1, before[2], before[3] + 1)
    graph.replay()
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1] + 1, before[2], before[3] + 1)
    torch.testing.assert_close(o, attention_ref(q, k, v)[0], atol=2e-5, rtol=0)
    torch.testing.assert_close(h, mamba_scan_ref(*inputs, final_state=True)[1], atol=2e-5, rtol=0)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device)


@pytest.mark.parametrize("model", ["qwen3-14b", "stablelm-3b", "hymba-1.5b", "xlstm-125m",
                                   "gemma3-27b", "glm4-9b"])
def test_reduced_serving_on_card_matches_cpu(cuda, model):
    """``BatchScheduler`` on the reduced config (fp32): the card (K3, and K4
    for hymba, in the prefill) gives the CPU's greedy tokens, and the
    prefill's logits and cache within 1e-4 relative."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params, prefill
    from repro_torch.serving import BatchScheduler

    cfg = get_config(model, reduced=True)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    on_card = _tree_to(params, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (16, 16, 128)]  # 128: past the window
    outs = []
    for p in (params, on_card):
        sched = BatchScheduler(cfg, p, max_batch=2, max_new=6)
        ids = [sched.submit(t) for t in prompts]
        sched.run()
        outs.append([sched.result(i) for i in ids])
    for cpu_tokens, card_tokens in zip(*outs):
        np.testing.assert_array_equal(card_tokens, cpu_tokens)
    tokens = torch.from_numpy(np.stack(prompts[:2]).astype(np.int32))
    want, want_cache = prefill(params, cfg, {"tokens": tokens}, 24)
    got, got_cache = prefill(on_card, cfg, {"tokens": tokens.to(cuda)}, 24)
    flat = lambda c: [t for v in c.values() for t in (v if isinstance(v, tuple) else (v,))]  # noqa: E731
    for g, w in [(got, want), *zip(flat(got_cache), flat(want_cache))]:
        assert (g.cpu() - w).abs().max().item() <= 1e-4 * max(1.0, w.abs().max().item())


@pytest.mark.parametrize("b,s,h,kv", [
    (4, 128, 32, 32), (4, 1280, 32, 32),   # musicgen-large's prefill
    (4, 384, 14, 2), (4, 1280, 14, 2),     # internvl2-1b's: a GQA group of 7
])
def test_flash_attention_modal_prefill_shapes_match_plain(cuda, b, s, h, kv):
    g = torch.Generator().manual_seed(b * s + h)
    q, k, v = (torch.randn(b, s, n, 64, generator=g).to(torch.bfloat16).to(cuda)
               for n in (h, kv, kv))
    do = torch.randn(b, s, h, 64, generator=g).to(torch.bfloat16).to(cuda)
    _check_flash_against_plain(q, k, v, do, 0, 1.0)


@pytest.mark.parametrize("model", ["musicgen-large", "internvl2-1b"])
def test_reduced_modal_serving_on_card_matches_cpu(cuda, model):
    """Frame and patch prompts on the reduced config (fp32): the card's
    prefill logits and cache within 1e-4 relative of the CPU's, and three
    greedy decode steps (a frames model feeding back the code's embedding)
    give the CPU's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.configs.inputs import dummy_batch
    from repro_torch.models.transformer import decode_step, init_params, prefill

    cfg = get_config(model, reduced=True)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    batch = {k: v for k, v in dummy_batch(cfg, 2, 64, seed=1).items() if k != "labels"}
    runs = []
    for dev in ("cpu", cuda):
        p = _tree_to(params, dev)
        logits, cache = prefill(p, cfg, _tree_to(batch, dev), 72)
        # copies: decode_step advances the cache in place (on the CPU too)
        first = (logits.cpu().clone(), {k: v.cpu().clone() for k, v in cache.items()})
        toks = [logits.argmax(-1)]
        for pos in range(64, 67):
            tok = toks[-1][:, None]
            step = ({"frame": p["embed"][tok[:, 0]][:, None, :]} if cfg.input_mode == "frames"
                    else {"token": tok.to(torch.int32)})
            logits, cache = decode_step(p, cfg, step, cache, pos)
            toks.append(logits.argmax(-1))
        runs.append((first, torch.stack(toks).cpu()))
    (want, want_cache), want_toks = runs[0]
    (got, got_cache), got_toks = runs[1]
    for g, w in [(got, want), *((got_cache[k], want_cache[k]) for k in want_cache)]:
        assert (g - w).abs().max().item() <= 1e-4 * max(1.0, w.abs().max().item())
    assert torch.equal(got_toks, want_toks)


def test_scaleout_engine_on_card_matches_cpu(cuda):
    """The scaleout backend in a world of one: the card (K1 once a round
    over the (K, P) stack) selects as the CPU does and lands within 1e-5."""
    train = make_classification(800, n_features=64, n_classes=10, seed=0)
    test = make_classification(200, n_features=64, n_classes=10, seed=1)
    cfg = FLConfig(backend="scaleout", n_clients=12, m=4, rounds=3, hidden=(16,),
                   eval_samples=16, eval_every=1, target_hd=0.8, strategy_kwargs={"J": 3})
    runs = {}
    for dev in ("cpu", "cuda"):
        before = masked_weighted_sum.launches
        eng = make_engine(cfg, train, test, 10, device=dev)
        runs[dev] = ([r.selected for r in eng.rounds()], eng.params.cpu(),
                     masked_weighted_sum.launches - before)
    assert runs["cuda"][0] == runs["cpu"][0] and runs["cuda"][2] == 3 and runs["cpu"][2] == 0
    torch.testing.assert_close(runs["cuda"][1], runs["cpu"][1], atol=1e-5, rtol=0)
