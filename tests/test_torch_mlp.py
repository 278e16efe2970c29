"""Port parity: the MLP forward, loss, accuracy and one ``local_train``
call against ``repro.models.mlp`` / ``repro.federated.client`` on the same
weights and the same batch indices.

Tolerance atol 1e-5: both sides are full fp32, but the matrix products
sum in different orders (XLA's dot vs PyTorch's), and a few SGD steps
carry those differences forward."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.mlp as ref  # noqa: E402
from repro.federated.client import _sample_batch, local_train as ref_local_train  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.device import pin_fp32_matmul  # noqa: E402
from repro_torch.federated.client import local_train  # noqa: E402
import repro_torch.models.mlp as port  # noqa: E402

SIZES = (64, 16, 10)
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fp32():
    pin_fp32_matmul()


def _setup(seed=0, sizes=SIZES):
    params = jax.tree.map(np.asarray, ref.init_mlp(jax.random.PRNGKey(seed), sizes))
    layout = port.MLPLayout(sizes)
    return params, layout, params_from_jax(params)


def test_layout_and_conversion_roundtrip():
    params, layout, flat = _setup(sizes=(784, 200, 200, 10))
    assert layout.n_params == flat.numel() == 199_210
    back = params_to_numpy(flat, (784, 200, 200, 10))
    for a, b in zip(params, back):
        np.testing.assert_array_equal(a["w"], b["w"])
        np.testing.assert_array_equal(a["b"], b["b"])
    w0, b0 = layout.views(flat)[0]
    assert w0.data_ptr() == flat.data_ptr()  # views, not copies


def test_init_mlp_he_scale_and_determinism():
    g = torch.Generator().manual_seed(3)
    flat = port.init_mlp(g, (784, 200, 10))
    layers = port.MLPLayout((784, 200, 10)).views(flat)
    assert abs(layers[0][0].std().item() - (2 / 784) ** 0.5) < 2e-3
    assert torch.all(layers[0][1] == 0)
    assert torch.equal(flat, port.init_mlp(torch.Generator().manual_seed(3), (784, 200, 10)))


def test_forward_loss_accuracy_match():
    params, layout, flat = _setup()
    rng = np.random.default_rng(0)
    x = rng.random((32, SIZES[0]), dtype=np.float32)
    y = rng.integers(0, 10, 32)
    w = (rng.random(32) > 0.4).astype(np.float32)
    pj = jax.tree.map(jnp.asarray, params)
    want = ref.mlp_apply(pj, jnp.asarray(x))
    got = port.mlp_apply(layout.views(flat), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    yt = torch.from_numpy(y)
    np.testing.assert_allclose(port.cross_entropy_loss(got, yt).item(),
                               float(ref.cross_entropy_loss(want, jnp.asarray(y))), atol=ATOL)
    np.testing.assert_allclose(
        port.cross_entropy_loss(got, yt, torch.from_numpy(w)).item(),
        float(ref.cross_entropy_loss(want, jnp.asarray(y), jnp.asarray(w))), atol=ATOL)
    assert port.accuracy(got, yt).item() == float(ref.accuracy(want, jnp.asarray(y)))


def test_cohort_forward_matches_per_model():
    cohort = [_setup(seed)[0] for seed in range(3)]
    layout = port.MLPLayout(SIZES)
    flat = torch.stack([params_from_jax(p) for p in cohort])  # (m, P)
    x = np.random.default_rng(1).random((3, 8, SIZES[0]), dtype=np.float32)
    got = port.mlp_apply(layout.views(flat), torch.from_numpy(x))
    for i, p in enumerate(cohort):
        want = ref.mlp_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=ATOL)


def test_local_train_matches_reference_on_same_batches():
    params, layout, flat = _setup()
    rng = np.random.default_rng(2)
    m, n_max, steps, batch, lr = 3, 40, 4, 8, 0.05
    x = rng.random((m, n_max, SIZES[0]), dtype=np.float32)
    y = rng.integers(0, 10, (m, n_max))
    mask = np.ones((m, n_max), np.float32)
    mask[1, 25:] = 0.0   # a smaller client
    tau = np.array([4, 2, 1], np.int32)  # clients 1, 2 freeze early (live gating)
    keys = [jax.random.PRNGKey(10 + i) for i in range(m)]
    # the reference draws its batch rows inside local_train: replay them
    bidx = np.stack([
        np.stack([np.asarray(_sample_batch(k, jnp.asarray(mask[i]), batch))
                  for k in jax.random.split(keys[i], steps)])
        for i in range(m)
    ]).transpose(1, 0, 2)  # (steps, m, batch)

    def apply_fn(p, xb):
        return port.mlp_apply(layout.views(p), xb)

    got_p, got_l = local_train(apply_fn, port.cross_entropy_loss, flat,
                               torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(bidx), torch.from_numpy(tau),
                               lr=lr, max_steps=steps)
    pj = jax.tree.map(jnp.asarray, params)
    for i in range(m):
        want_p, want_l = ref_local_train(
            ref.mlp_apply, ref.cross_entropy_loss, pj, jnp.asarray(x[i]), jnp.asarray(y[i]),
            jnp.asarray(mask[i]), jnp.asarray(tau[i]), keys[i],
            lr=lr, max_steps=steps, batch_size=batch)
        want = params_from_jax(jax.tree.map(np.asarray, want_p)).numpy()
        np.testing.assert_allclose(got_p[i].numpy(), want, atol=ATOL)
        np.testing.assert_allclose(got_l[i].item(), float(want_l), atol=ATOL)
    # client 2 took exactly one step; a frozen step leaves its params alone
    assert not torch.equal(got_p[2], flat)
