"""Port parity: Algorithm 1 (``fedlecc_select``) selects exactly the
reference's clients over seeded loss vectors, including ties and ``-inf``
(unavailable) entries; ``selection_weights`` matches."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.core.selection as ref  # noqa: E402
import repro_torch.core.selection as port  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(5, 60))
    n_clusters = int(rng.integers(1, min(k, 9) + 1))
    labels = rng.integers(0, n_clusters, k)
    losses = rng.gamma(2.0, 1.0, k).astype(np.float32)
    if seed % 3 == 0:  # ties
        losses = np.round(losses, 1)
    if seed % 2 == 0:  # unavailable clients
        losses[rng.random(k) < 0.3] = -np.inf
    if seed % 7 == 0:  # a whole cluster offline
        losses[labels == labels[0]] = -np.inf
    m = int(rng.integers(1, k + 1))
    J = int(rng.integers(1, n_clusters + 2))
    return labels, losses, m, J


@pytest.mark.parametrize("seed", range(60))
def test_fedlecc_select_identical(seed):
    labels, losses, m, J = _case(seed)
    got = port.fedlecc_select(labels, losses, m=m, J=J)
    want = ref.fedlecc_select(labels, losses, m=m, J=J)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and len(got) == min(m, len(labels))


def test_selection_weights_match():
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 100, 20)
    mask = rng.random(20) < 0.4
    got = port.selection_weights(torch.from_numpy(mask), torch.from_numpy(sizes)).numpy()
    want = np.asarray(ref.selection_weights(jnp.asarray(mask), jnp.asarray(sizes)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[~mask].sum() == 0.0
