"""Port parity for the aggregation rules and the local-objective
modifiers: ``repro_torch.federated.aggregation``, the registered
aggregators and ``repro_torch.optim.fedmods`` against the reference's
functions, on MLP cohorts built in the reference's pytree layout and
converted with ``params_from_jax``.  Tolerance atol 1e-5 (fp32 sums taken
in another order: the port reduces the flat cohort with one FedAvg reduce
call where the reference sums per leaf).  On the CPU the reduce is its
plain version; ``tests/test_torch_gpu.py`` holds the kernel to it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro_torch.federated.aggregation as port_aggregation  # noqa: E402
from repro.engine.aggregators import get_aggregator as ref_get_aggregator  # noqa: E402
from repro.engine.config import FLConfig as RefFLConfig  # noqa: E402
from repro.federated import aggregation as ref  # noqa: E402
from repro.models.mlp import init_mlp  # noqa: E402
from repro.optim import fedmods as ref_fedmods  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.engine import FLConfig  # noqa: E402
from repro_torch.engine.aggregators import get_aggregator  # noqa: E402
from repro_torch.federated.aggregation import (  # noqa: E402
    coordinate_median,
    feddyn_server,
    feddyn_update_h,
    fednova,
    trimmed_mean,
)
from repro_torch.kernels.aggregate import masked_weighted_sum  # noqa: E402
from repro_torch.optim.fedmods import (  # noqa: E402
    feddyn_grads,
    feddyn_update_state,
    fedprox_grads,
)

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


def _cohort(m, seed, ties=False):
    """(global pytree, stacked pytree with a leading client axis, and the
    same as flat torch tensors (P,) and (m, P)).  ``ties`` makes client 1
    a copy of client 0, so every coordinate has a tied pair."""
    rng = np.random.default_rng(seed)
    g = jax.tree.map(np.asarray, init_mlp(jax.random.PRNGKey(seed), SIZES))
    clients = [jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), g)
               for _ in range(m)]
    if ties:
        clients[1] = clients[0]
    stacked = jax.tree.map(lambda *a: np.stack(a), *clients)
    flat = torch.stack([params_from_jax(c) for c in clients])
    return g, stacked, params_from_jax(g), flat


def _weights(m, seed, zero_rows=()):
    rng = np.random.default_rng(seed + 50)
    w = rng.uniform(0.5, 2.0, m).astype(np.float32)
    w[list(zero_rows)] = 0.0
    return w / w.sum()


def _flat(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree)).numpy()


@pytest.mark.parametrize("m,seed", [(4, 0), (10, 1)])
def test_fednova_matches_reference(m, seed):
    g, stacked, g_t, flat = _cohort(m, seed)
    w = _weights(m, seed)
    taus = np.random.default_rng(seed).integers(0, 9, m).astype(np.float32)  # τ = 0 clips to 1
    before = flat.clone()
    got = fednova(flat, g_t, torch.from_numpy(w), torch.from_numpy(taus))
    want = _flat(ref.fednova(stacked, g, jnp.asarray(w), jnp.asarray(taus)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert torch.equal(flat, before)  # FedDyn's client update reads the cohort afterwards


def test_fednova_reduces_the_cohort_once(monkeypatch):
    calls = []
    real = port_aggregation.masked_weighted_sum
    monkeypatch.setattr(port_aggregation, "masked_weighted_sum",
                        lambda x, w: calls.append(x.shape) or real(x, w))
    _, _, g_t, flat = _cohort(5, 3)
    fednova(flat, g_t, torch.from_numpy(_weights(5, 3)), torch.full((5,), 3.0))
    assert calls == [tuple(flat.shape)]


@pytest.mark.parametrize("alpha,frac", [(0.1, 0.1), (0.5, 0.3)])
def test_feddyn_server_and_h_update_match_reference(alpha, frac):
    m = 6
    g, stacked, g_t, flat = _cohort(m, 4)
    w = _weights(m, 4)
    rng = np.random.default_rng(9)
    h = jax.tree.map(lambda a: (0.01 * rng.standard_normal(a.shape)).astype(np.float32), g)
    h_t = params_from_jax(h)
    theta, mean = feddyn_server(flat, torch.from_numpy(w), h_t, alpha)
    theta_ref, mean_ref = ref.feddyn_server(stacked, jnp.asarray(w), h, alpha, frac)
    np.testing.assert_allclose(theta.numpy(), _flat(theta_ref), atol=ATOL)
    np.testing.assert_allclose(mean.numpy(), _flat(mean_ref), atol=ATOL)
    h_new = feddyn_update_h(h_t, mean, g_t, alpha, frac)
    np.testing.assert_allclose(h_new.numpy(), _flat(ref.feddyn_update_h(h, mean_ref, g, alpha, frac)),
                               atol=ATOL)


@pytest.mark.parametrize("m,zero_rows,ties", [(5, (), False), (10, (), True), (8, (2, 5), False),
                                              (9, (0,), True)])
@pytest.mark.parametrize("trim_frac", [0.0, 0.1, 0.2, 0.4])
def test_trimmed_mean_matches_reference(m, zero_rows, ties, trim_frac):
    _, stacked, _, flat = _cohort(m, m, ties=ties)
    w = _weights(m, m, zero_rows)
    got = trimmed_mean(flat, torch.from_numpy(w), trim_frac)
    want = _flat(ref.trimmed_mean(stacked, jnp.asarray(w), trim_frac))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("m,zero_rows", [(5, ()), (6, ()), (8, (1, 4, 7)), (7, (3,))])
def test_coordinate_median_matches_reference(m, zero_rows):
    _, stacked, _, flat = _cohort(m, m + 20, ties=True)
    w = _weights(m, m, zero_rows)
    got = coordinate_median(flat, torch.from_numpy(w))
    want = _flat(ref.coordinate_median(stacked, jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_sorting_rules_give_the_same_result_in_column_chunks(monkeypatch):
    _, _, _, flat = _cohort(7, 5, ties=True)
    w = torch.from_numpy(_weights(7, 5, (2,)))
    whole = (trimmed_mean(flat, w, 0.2), coordinate_median(flat, w))
    monkeypatch.setattr(port_aggregation, "_SORT_COLUMNS", 97)  # ragged last chunk
    chunked = (trimmed_mean(flat, w, 0.2), coordinate_median(flat, w))
    # the median gathers; the trimmed mean's sums over the client axis may
    # vectorize differently at another column count (last-bit differences)
    assert torch.equal(whole[1], chunked[1])
    np.testing.assert_allclose(whole[0].numpy(), chunked[0].numpy(), rtol=0, atol=1e-6)


def test_trimmed_mean_without_trimming_is_the_weighted_mean():
    _, _, _, flat = _cohort(6, 8)
    w = torch.from_numpy(_weights(6, 8))
    np.testing.assert_allclose(trimmed_mean(flat, w, 0.0).numpy(),
                               masked_weighted_sum(flat, w).numpy(), atol=ATOL)


@pytest.mark.parametrize("name", ["fedavg", "fednova", "feddyn", "trimmed_mean",
                                  "coordinate_median"])
def test_aggregator_objects_match_reference_over_rounds(name):
    """Two rounds through ``aggregate`` and ``update_state``, state threaded
    (FedDyn's server h), with the reference's aggregator objects."""
    kw = dict(n_clients=12, m=4, aggregator=name, mu=0.1, hidden=(16,))
    cfg, ref_cfg = FLConfig(**kw), RefFLConfig(**kw)
    agg, ref_agg = get_aggregator(name, cfg), ref_get_aggregator(name, ref_cfg)
    g, _, g_t, _ = _cohort(4, 11)
    state, ref_state = agg.init_state(g_t), ref_agg.init_state(g)
    for rnd in range(2):
        _, stacked, _, flat = _cohort(4, 20 + rnd)
        w = _weights(4, rnd)
        taus = np.array([3, 1, 4, 2], np.float32)
        new = agg.aggregate(flat, g_t, torch.from_numpy(w), torch.from_numpy(taus), state, 4)
        ref_new = ref_agg.aggregate(stacked, g, jnp.asarray(w), jnp.asarray(taus), ref_state, 4)
        state = agg.update_state(state, flat, g_t, torch.from_numpy(w), 4)
        ref_state = ref_agg.update_state(ref_state, stacked, g, jnp.asarray(w), 4)
        np.testing.assert_allclose(new.numpy(), _flat(ref_new), atol=ATOL)
        if agg.needs_state:
            np.testing.assert_allclose(state.numpy(), _flat(ref_state), atol=ATOL)
        g, g_t = jax.tree.map(np.asarray, ref_new), new


@pytest.mark.parametrize("trim_frac", [-0.1, 0.5])
def test_trimmed_mean_rejects_trim_frac_outside_range(trim_frac):
    with pytest.raises(ValueError, match="trim_frac"):
        FLConfig(aggregator="trimmed_mean", aggregator_kwargs={"trim_frac": trim_frac})
    assert get_aggregator("trimmed_mean", FLConfig(aggregator="trimmed_mean")).trim_frac == 0.2


@pytest.mark.parametrize("mu", [0.01, 0.3])
def test_fedmods_match_reference(mu):
    """The in-place cohort transforms against the reference's per-leaf ones,
    client by client; they write into (and return) the tensor they update."""
    m = 3
    g, stacked, g_t, flat = _cohort(m, 12)
    rng = np.random.default_rng(13)
    grads = rng.standard_normal(flat.shape).astype(np.float32)
    h = (0.1 * rng.standard_normal(flat.shape)).astype(np.float32)
    clients = [jax.tree.map(lambda a, i=i: a[i], stacked) for i in range(m)]

    def per_client(i, a):  # row i of a flat (m, P) array as a reference pytree
        return params_to_numpy(torch.from_numpy(np.ascontiguousarray(a[i])), SIZES)

    buf = torch.from_numpy(grads.copy())
    out = fedprox_grads(buf, flat, g_t, mu)
    assert out.data_ptr() == buf.data_ptr()
    for i in range(m):
        want = ref_fedmods.fedprox_grads(per_client(i, grads), clients[i], g, mu)
        np.testing.assert_allclose(out[i].numpy(), _flat(want), atol=ATOL)
    buf = torch.from_numpy(grads.copy())
    out = feddyn_grads(buf, flat, g_t, torch.from_numpy(h), mu)
    assert out.data_ptr() == buf.data_ptr()
    for i in range(m):
        want = ref_fedmods.feddyn_grads(per_client(i, grads), clients[i], g, per_client(i, h), mu)
        np.testing.assert_allclose(out[i].numpy(), _flat(want), atol=ATOL)
    buf = torch.from_numpy(h.copy())
    out = feddyn_update_state(buf, flat, g_t, mu)
    assert out.data_ptr() == buf.data_ptr()
    for i in range(m):
        want = ref_fedmods.feddyn_update_state(per_client(i, h), clients[i], g, mu)
        np.testing.assert_allclose(out[i].numpy(), _flat(want), atol=ATOL)
