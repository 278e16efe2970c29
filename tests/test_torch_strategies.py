"""Port parity for the selection strategies and the clustering they use:
each registered strategy of ``repro_torch.core.strategies`` against the
reference's on identical inputs — the same histograms and client sizes,
float32 losses with ``-inf`` (offline) entries, and numpy generators of
one seed.  Selections must be equal, and both generators must end in the
same state (the same draws, in the same order).

The strategies that build a Hellinger matrix (``haccs``, ``fedcor``,
``clusterrandom``, fedlecc's ``cluster="auto"``) are also run with the
*same* matrix fed to both packages: the packages sum its inner products
in different fp32 orders, so this isolates the strategy from that order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core.hellinger as ref_hellinger  # noqa: E402
import repro.core.strategies as ref_strategies  # noqa: E402
from conftest import planted_histograms  # noqa: E402

import repro_torch.core.clustering as port_clustering  # noqa: E402
import repro_torch.core.strategies as port_strategies  # noqa: E402
from repro.core.clustering import best_clustering as ref_best_clustering  # noqa: E402
from repro.core.clustering import kmedoids as ref_kmedoids  # noqa: E402
from repro.core.clustering import silhouette_score as ref_silhouette  # noqa: E402
from repro.engine.registry import STRATEGY_REGISTRY as REF_STRATEGIES  # noqa: E402
from repro_torch.core.clustering import best_clustering, kmedoids, silhouette_score  # noqa: E402
from repro_torch.engine.registry import STRATEGY_REGISTRY  # noqa: E402

# name -> strategy kwargs; "fedlecc_auto" is fedlecc with cluster="auto"
CASES = {
    "random": ("random", {}),
    "fedlecc": ("fedlecc", {"J": 3}),
    "fedlecc_auto": ("fedlecc", {"J": 3, "cluster": "auto"}),
    "poc": ("poc", {}),
    "haccs": ("haccs", {}),
    "fedcs": ("fedcs", {}),
    "fedcls": ("fedcls", {}),
    "fedcor": ("fedcor", {}),
    "lossonly": ("lossonly", {}),
    "clusterrandom": ("clusterrandom", {"J": 3}),
    "fedlecc_adaptive": ("fedlecc_adaptive", {}),
}
SIZES = [(0, 24, 4), (1, 60, 10), (2, 100, 10)]  # (seed, K, m)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, K, structured=True):
    rng = np.random.default_rng(seed)
    if structured:
        hists, _ = planted_histograms(rng, K=K)
    else:  # no density structure: OPTICS' silhouette is poor, "auto" sweeps k-medoids
        hists = rng.dirichlet(np.ones(10), size=K)
    sizes = rng.integers(5, 60, K)
    return rng, hists, sizes


def _losses(rng, K, rnd):
    """float32 losses with ties and, from round 1 on, a few offline clients."""
    losses = np.round(rng.gamma(2.0, 1.0, K), 1).astype(np.float32)
    if rnd:
        losses[rng.choice(K, size=max(1, K // 8), replace=False)] = -np.inf
    return losses


def _pair(case, m, hists, sizes, seed):
    name, kw = CASES[case]
    ref = REF_STRATEGIES.build(name, m=m, **kw)
    ref.setup(hists, sizes, seed=seed)
    port = STRATEGY_REGISTRY.build(name, m=m, **kw)
    port.setup(hists, sizes, seed=seed, device="cpu")
    return ref, port


def _assert_same_selections(ref, port, K, seed, rounds=4):
    draw = np.random.default_rng(seed + 100)
    r_ref, r_port = np.random.default_rng(seed + 7), np.random.default_rng(seed + 7)
    for rnd in range(rounds):
        losses = _losses(draw, K, rnd)
        want = ref.select(rnd, losses.copy(), r_ref)
        got = port.select(rnd, losses.copy(), r_port)
        np.testing.assert_array_equal(got, want)
        assert len(got) == min(port.m, K) and len(set(got.tolist())) == len(got)
    assert r_port.bit_generator.state == r_ref.bit_generator.state


def test_every_reference_strategy_is_registered():
    assert STRATEGY_REGISTRY.names() == REF_STRATEGIES.names()


@pytest.mark.parametrize("seed,K,m", SIZES)
@pytest.mark.parametrize("case", list(CASES))
def test_select_matches_reference(case, seed, K, m):
    _, hists, sizes = _inputs(seed, K)
    ref, port = _pair(case, m, hists, sizes, seed)
    for attr in ("labels", "n_clusters", "cluster_method", "latency", "presence"):
        if hasattr(ref, attr):
            np.testing.assert_array_equal(getattr(port, attr), getattr(ref, attr))
    assert (port.needs_losses, port.needs_histograms) == (ref.needs_losses, ref.needs_histograms)
    assert port.extra_upload_bytes_per_round() == ref.extra_upload_bytes_per_round()
    assert port.profile_latency is None
    _assert_same_selections(ref, port, K, seed)


@pytest.mark.parametrize("seed,structured", [(0, True), (1, False), (2, False)])
@pytest.mark.parametrize("case", ["haccs", "fedcor", "clusterrandom", "fedlecc_auto"])
def test_select_matches_reference_on_the_same_matrix(monkeypatch, case, seed, structured):
    K, m = 40, 6
    _, hists, sizes = _inputs(seed, K, structured)
    d = ref_hellinger.hellinger_blocked(hists)
    same = lambda *a, **k: d.copy()  # noqa: E731
    for mod in (ref_hellinger, ref_strategies, port_clustering, port_strategies):
        monkeypatch.setattr(mod, "hellinger_blocked", same)
    ref, port = _pair(case, m, hists, sizes, seed)
    if hasattr(ref, "Kmat"):
        np.testing.assert_array_equal(port.Kmat, ref.Kmat)
        assert port.Kmat.dtype == ref.Kmat.dtype == np.float32
    else:
        np.testing.assert_array_equal(port.labels, ref.labels)
    _assert_same_selections(ref, port, K, seed)


def test_cluster_auto_sweeps_kmedoids_on_unstructured_histograms():
    """The unstructured inputs of the same-matrix test do reach k-medoids."""
    _, hists, sizes = _inputs(1, 40, structured=False)
    _, port = _pair("fedlecc_auto", 6, hists, sizes, 1)
    assert port.cluster_method == "kmedoids"


@pytest.mark.parametrize("seed,structured", [(0, True), (1, False), (3, False)])
def test_clustering_matches_reference(seed, structured):
    _, hists, _ = _inputs(seed, 36, structured)
    d = ref_hellinger.hellinger_blocked(hists)
    for k in (2, 5, 9):
        np.testing.assert_array_equal(kmedoids(d, k, seed=seed), ref_kmedoids(d, k, seed=seed))
    labels = kmedoids(d, 4, seed=seed)
    assert silhouette_score(d, labels) == ref_silhouette(d, labels)
    assert silhouette_score(d, np.zeros(36, np.int64)) == 0.0
    got, want = best_clustering(d, seed=seed), ref_best_clustering(d, seed=seed)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_fedlecc_adaptive_round_J_ignores_offline_clients():
    labels = np.repeat(np.arange(4), 3)
    s = STRATEGY_REGISTRY.build("fedlecc_adaptive", m=6)
    s.labels, s.n_clusters, s.K = labels, 4, 12
    ref = REF_STRATEGIES.build("fedlecc_adaptive", m=6)
    ref.labels, ref.n_clusters, ref.K = labels, 4, 12
    losses = np.array([5, 5, 5, 1, 1, -np.inf, 4, -np.inf, 4, -np.inf, -np.inf, -np.inf],
                      np.float32)
    assert s._round_J(losses) == ref._round_J(losses) == 2
    assert s._round_J(np.full(12, -np.inf, np.float32)) == ref._round_J(
        np.full(12, -np.inf, np.float32)) == 1
