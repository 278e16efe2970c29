"""The port's mask selections against its own ``select`` and against the
reference's masks, on identical inputs, rng states and keys.

For every strategy with a mask selection, ``select_mask`` must equal the
port's ``select`` and the reference's ``select_mask_jax`` exactly, on
random losses (hypothesis), on tied losses and under ``-inf`` gates; for
every strategy with a traced selection, ``select_mask_traced`` on the
noise that ``JaxReplayDraws`` makes from a key must equal the reference's
``select_mask_traced`` on that key.  ``fedlecc_select_mask`` must equal
``fedlecc_select_jax`` and ``cohort_indices`` ``np.where``.  Exact
equality throughout: selections are discrete."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core.selection import fedlecc_select_jax  # noqa: E402
from repro.core.strategies import get_strategy as ref_get_strategy  # noqa: E402
from repro.engine import mask_selection_strategies as ref_mask_strategies  # noqa: E402
from repro.engine.registry import traced_selection_strategies as ref_traced  # noqa: E402
from repro_torch.core.selection import cohort_indices, fedlecc_select_mask  # noqa: E402
from repro_torch.engine import mask_selection_strategies, traced_selection_strategies  # noqa: E402
from repro_torch.engine.registry import STRATEGY_REGISTRY  # noqa: E402
from test_torch_engine import jax_selection_noise  # noqa: E402

MASK = mask_selection_strategies()
TRACED = traced_selection_strategies()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_capability_lists_match_the_reference():
    assert MASK == ref_mask_strategies() and TRACED == ref_traced()
    assert "fedlecc_adaptive" in MASK and "fedlecc_adaptive" not in TRACED
    assert not {"fedcls", "fedcor"} & set(MASK)


def _case(seed, k, m, g, losses=None):
    rng = np.random.default_rng(seed)
    modes = rng.dirichlet(np.ones(10) * 0.2, size=g)
    assign = rng.integers(0, g, k)
    hists = np.stack([rng.dirichlet(modes[a] * 200.0 + 1e-3) for a in assign])
    sizes = rng.integers(20, 200, k).astype(np.float64)
    if losses is None:
        losses = rng.uniform(0.1, 5.0, k).astype(np.float32)
    return hists, sizes, np.asarray(losses, np.float32)


def _pair(name, m, hists, sizes, seed):
    port = STRATEGY_REGISTRY.build(name, m=m)
    port.setup(hists, sizes, seed=seed, device="cpu")
    ref = ref_get_strategy(name, m=m)
    ref.setup(hists, sizes, seed=seed)
    return port, ref


def _check_mask(name, m, hists, sizes, losses, seed):
    port, ref = _pair(name, m, hists, sizes, seed)
    if hasattr(port, "labels"):
        np.testing.assert_array_equal(port.labels, ref.labels)
    mask = port.select_mask(torch.from_numpy(losses), np.random.default_rng(seed + 1))
    assert mask.dtype == torch.bool and mask.shape == (len(sizes),)
    assert int(mask.sum()) == min(m, len(sizes))
    sel = port.select(0, losses, np.random.default_rng(seed + 1))
    want = np.asarray(ref.select_mask_jax(jnp.asarray(losses), np.random.default_rng(seed + 1)))
    np.testing.assert_array_equal(np.flatnonzero(mask.numpy()), sel)
    np.testing.assert_array_equal(mask.numpy(), want)


@st.composite
def mask_case(draw):
    k = draw(st.integers(6, 40))
    return draw(st.integers(0, 2**31 - 1)), k, draw(st.integers(1, k)), draw(st.integers(1, 5))


@pytest.mark.parametrize("name", MASK)
@given(case=mask_case())
@settings(max_examples=8, deadline=None)
def test_select_mask_equals_select_and_reference(name, case):
    seed, k, m, g = case
    hists, sizes, losses = _case(seed, k, m, g)
    _check_mask(name, m, hists, sizes, losses, seed)


def _tied_losses(k):
    # few distinct values, all sums exact in fp32: cluster means tie too
    return np.random.default_rng(k).integers(1, 4, k).astype(np.float32)


def _gated_losses(k):
    losses = np.random.default_rng(k + 1).uniform(0.1, 5.0, k).astype(np.float32)
    losses[np.random.default_rng(k + 2).permutation(k)[: k // 3]] = -np.inf
    return losses


@pytest.mark.parametrize("name", MASK)
@pytest.mark.parametrize("kind", ["ties", "gates", "ties+gates", "all equal"])
def test_select_mask_ties_and_gates(name, kind):
    k, m, seed = 30, 7, 3
    losses = {"ties": _tied_losses(k), "gates": _gated_losses(k),
              "ties+gates": np.where(np.isinf(_gated_losses(k)), -np.inf, _tied_losses(k)),
              "all equal": np.ones(k)}[kind]
    hists, sizes, losses = _case(seed, k, m, 4, losses)
    _check_mask(name, m, hists, sizes, losses, seed)


@pytest.mark.parametrize("name", TRACED)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_mask_traced_equals_reference(name, seed):
    k, m = 24, 5
    hists, sizes, losses = _case(seed, k, m, 4)
    if seed == 2:
        losses = np.where(np.isinf(_gated_losses(k)), -np.inf, _tied_losses(k))
    port, ref = _pair(name, m, hists, sizes, seed)
    key = jax.random.PRNGKey(100 + seed)
    noise = jax_selection_noise(key, port.traced_noise, k, getattr(port, "n_clusters", 0))
    got = port.select_mask_traced(torch.from_numpy(losses), noise)
    want = np.asarray(ref.select_mask_traced(jnp.asarray(losses), key))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == m
    if port.traced_noise is None:  # deterministic given the losses: the eager mask
        assert torch.equal(got, port.select_mask(torch.from_numpy(losses),
                                                 np.random.default_rng(0)))


@pytest.mark.parametrize("name", ["random", "poc", "clusterrandom"])
def test_random_masks_need_rng(name):
    hists, sizes, losses = _case(0, 12, 3, 2)
    port, _ = _pair(name, 3, hists, sizes, 0)
    with pytest.raises(ValueError, match="pass rng"):
        port.select_mask(torch.from_numpy(losses), None)


@st.composite
def algorithm1_case(draw):
    k = draw(st.integers(1, 40))
    c = draw(st.integers(1, 6))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, k)
    labels[: min(c, k)] = np.arange(min(c, k))
    style = draw(st.sampled_from(["uniform", "ties", "gates"]))
    losses = (rng.integers(0, 3, k) if style == "ties" else rng.uniform(0, 4, k)).astype(np.float32)
    if style == "gates":
        losses[rng.random(k) < 0.4] = -np.inf
    m = draw(st.integers(1, k))
    J = draw(st.integers(1, c))
    return labels, losses, m, J, c


@given(case=algorithm1_case())
@settings(max_examples=30, deadline=None)
def test_fedlecc_select_mask_equals_reference(case):
    labels, losses, m, J, c = case
    got = fedlecc_select_mask(torch.from_numpy(labels), torch.from_numpy(losses), m, J, c)
    want = np.asarray(fedlecc_select_jax(jnp.asarray(labels), jnp.asarray(losses), m=m, J=J,
                                         n_clusters=c))
    np.testing.assert_array_equal(got.numpy(), want)
    idx = cohort_indices(got, m)
    assert idx.dtype == torch.int64 and idx.shape == (m,)
    np.testing.assert_array_equal(idx.numpy(), np.flatnonzero(want))


def test_cohort_indices_pads_a_short_mask_with_unselected_clients():
    mask = torch.tensor([False, True, False, False, True, False])
    assert cohort_indices(mask, 2).tolist() == [1, 4]
    assert cohort_indices(mask, 4).tolist() == [1, 4, 0, 2]  # weight zero in selection_weights
