"""Port parity: the FedAvg reduce.  The kernel's plain version and the
port's ``fedavg`` against ``masked_weighted_sum_ref``, the Pallas kernel
in interpret mode and the reference ``fedavg``.

Tolerances: fp32 at rtol 1e-6 (atol 1e-6 for sums that cancel to near 0),
since both sides accumulate in fp32 but XLA may order the sum over clients
differently; bf16 inputs at rtol 1e-2, the width of one bf16 rounding,
since XLA may keep or round bf16 intermediates differently."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.federated.aggregation import fedavg as ref_fedavg  # noqa: E402
from repro.kernels.aggregate.ops import masked_weighted_sum_pallas  # noqa: E402
from repro.kernels.aggregate.ref import masked_weighted_sum_ref as jax_ref  # noqa: E402
from repro.models.mlp import init_mlp  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.engine.aggregators import FedAvgAggregator  # noqa: E402
from repro_torch.engine.config import FLConfig  # noqa: E402
from repro_torch.federated.aggregation import fedavg  # noqa: E402
from repro_torch.kernels.aggregate import masked_weighted_sum, masked_weighted_sum_ref  # noqa: E402

TOL = {"float32": dict(rtol=1e-6, atol=1e-6), "bfloat16": dict(rtol=1e-2, atol=1e-2)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(m, n, dtype):
    rng = np.random.default_rng(m * n % 977)
    x = rng.normal(0, 1, (m, n)).astype(np.float32)
    w = (rng.uniform(0, 1, m) * (rng.random(m) > 0.3)).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    return xj, jnp.asarray(w), xt, torch.from_numpy(w)


@pytest.mark.parametrize("m,n", [(1, 512), (10, 1000), (3, 513), (10, 4099)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_reference_and_pallas(m, n, dtype):
    xj, wj, xt, wt = _inputs(m, n, dtype)
    got = masked_weighted_sum_ref(xt, wt).numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_allclose(got, np.asarray(jax_ref(xj, wj)), **TOL[dtype])
    np.testing.assert_allclose(
        got, np.asarray(masked_weighted_sum_pallas(xj, wj, interpret=True)), **TOL[dtype]
    )
    # the wrapper takes the plain version for CPU tensors, without a launch
    before = masked_weighted_sum.launches
    assert torch.equal(masked_weighted_sum(xt, wt), masked_weighted_sum_ref(xt, wt))
    assert masked_weighted_sum.launches == before


def test_fedavg_matches_reference_on_mlp_cohort():
    sizes = (64, 16, 10)
    cohort = [init_mlp(jax.random.PRNGKey(i), sizes) for i in range(4)]
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *cohort)
    w = np.array([0.1, 0.4, 0.2, 0.3], np.float32)
    want = params_from_jax(jax.tree.map(np.asarray, ref_fedavg(stacked, jnp.asarray(w))))
    cohort_t = torch.stack([params_from_jax(jax.tree.map(np.asarray, p)) for p in cohort])
    got = fedavg(cohort_t, torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL["float32"])
    agg = FedAvgAggregator(FLConfig(n_clients=4, m=2))
    got2 = agg.aggregate(cohort_t, cohort_t[0], torch.from_numpy(w), None, None, n_selected=4)
    assert torch.equal(got2, got)


def test_wrapper_rejects_bad_inputs():
    x, w = torch.rand(3, 8), torch.rand(3)
    with pytest.raises(TypeError):
        masked_weighted_sum(x.double(), w)
    with pytest.raises(TypeError):
        masked_weighted_sum(x, w.double())
    with pytest.raises(ValueError):
        masked_weighted_sum(x, torch.rand(4))
    with pytest.raises(ValueError):
        masked_weighted_sum(x.t(), torch.rand(8))
