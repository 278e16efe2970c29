"""The port's CUDA kernels and engine on the card.  Every test here needs
a CUDA device and skips without one; it imports neither JAX nor the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Both kernels repeat their plain version's arithmetic operation for
operation (fp32, separately rounded multiply and add, index order), so
they must agree with it exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import make_classification  # noqa: E402
from repro_torch.engine import FLConfig, make_engine  # noqa: E402
from repro_torch.kernels.aggregate import masked_weighted_sum, masked_weighted_sum_ref  # noqa: E402
from repro_torch.kernels.hellinger import hellinger_strip, hellinger_strip_ref  # noqa: E402

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
