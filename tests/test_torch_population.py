"""The population axis of the port (``repro_torch.population``,
``FLConfig.population``) against the reference's ``repro.population``.

- The store, exactly: ``shard_layout``; ``SyntheticShardLoader``'s
  summaries and loads bit for bit (the same numpy streams); the LRU bound
  and laziness of ``ShardedStore``, driven alike in both packages;
  ``ShardedStore`` gathers equal to ``materialize_store``'s.
- ``kmedoids_hists``: labels equal to the reference's on seeded,
  well-separated histograms on the CPU, and equal given the reference's own
  Hellinger strips on mixed ones.
- ``HierarchicalSelector``, exactly: the shard labels (OPTICS, and
  k-medoids past the OPTICS limit), the explore-first order of
  ``choose_shards``, the loss-blind stream, ``observe``'s estimates,
  ``select_cohort`` and the ``state_dict`` round trip.
- The config: every cross-check with the reference's message.
- The engine: one shard gives the flat engine's bits (fedlecc, random and
  lossonly on host and compiled); 4 shards with 2 resident against the
  reference under ``JaxReplayDraws`` on host and compiled (and under the
  systems and fault axes on host), selections, the resident sets and
  ``comm_mb`` exactly, losses and the shard estimates (their means) within
  1e-4 and params within 1e-5 (fp32 sums in other orders, as
  ``tests/test_torch_engine.py``);
  the cohort inside the resident shards; resident polls billed only;
  kill-and-resume bit-identical; the undersized-resident error; and no
  (K, N_max) tensor held by a population engine."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from conftest import fl_cfg  # noqa: E402
from test_torch_engine import JaxReplayDraws  # noqa: E402

import repro.population as ref_pop  # noqa: E402
import repro_torch.population as pop  # noqa: E402
from repro.core.clustering import kmedoids_hists as ref_kmedoids_hists  # noqa: E402
from repro.core.hellinger import hellinger_rows as ref_hellinger_rows  # noqa: E402
from repro.engine import make_engine as ref_make_engine  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.clustering import _kmedoids_hists, kmedoids_hists  # noqa: E402
from repro_torch.engine import FLConfig, PopulationConfig, make_engine  # noqa: E402

POP = {"n_shards": 4, "shards_per_round": 2, "j_shards": 2}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's small engine runs from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raises_same(make_ref, make_port):
    with pytest.raises(ValueError) as want:
        make_ref()
    with pytest.raises(ValueError) as got:
        make_port()
    assert str(got.value) == str(want.value)


def _equal(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ store
@pytest.mark.parametrize("k,s", [(103, 7), (12, 1), (5, 5), (1000, 15)])
def test_shard_layout_equals_the_reference(k, s):
    for a, b in zip(pop.shard_layout(k, s), ref_pop.shard_layout(k, s), strict=True):
        _equal(a, b)
    _raises_same(lambda: ref_pop.shard_layout(k, k + 1), lambda: pop.shard_layout(k, k + 1))
    _raises_same(lambda: ref_pop.shard_layout(k, 0), lambda: pop.shard_layout(k, 0))


@pytest.mark.parametrize("seed,shard", [(7, 2), (0, 0), (3, 11)])
def test_synthetic_loader_equals_the_reference_bit_for_bit(seed, shard):
    kw = dict(seed=seed, n_classes=6, n_features=8, samples=(3, 9), skew=0.7)
    loader, ref = pop.SyntheticShardLoader(**kw), ref_pop.SyntheticShardLoader(**kw)
    members = pop.shard_layout(64, 4)[shard % 4]
    for a, b in zip(loader.summary(shard, members), ref.summary(shard, members)):
        _equal(a, b)
    got, want = loader.load(shard, members), ref.load(shard, members)
    assert got._fields == want._fields
    for a, b in zip(got, want):
        _equal(a, b)
    _equal(loader.protos, ref.protos)
    for bad in ({"samples": (0, 4)}, {"samples": (5, 4)}, {"skew": 1.5}):
        _raises_same(lambda: ref_pop.SyntheticShardLoader(**bad),
                     lambda: pop.SyntheticShardLoader(**bad))


def _stores(n_clients=40, n_shards=8, max_cached=2, seed=1):
    kw = dict(seed=seed, n_classes=4, n_features=5)
    return (pop.ShardedStore(pop.SyntheticShardLoader(**kw), n_clients, n_shards, max_cached,
                             device="cpu"),
            ref_pop.ShardedStore(ref_pop.SyntheticShardLoader(**kw), n_clients, n_shards,
                                 max_cached))


def test_sharded_store_lazy_and_lru_bound_like_the_reference():
    store, ref = _stores()
    _equal(store.shard_hists(), ref.shard_hists())
    _equal(store.client_sizes(), ref.client_sizes())
    assert store.materialized_shards() == () and store.load_count == 0
    first = None
    # [6] evicts 1, [1] reloads it and evicts 5; [6, 2] loads 2 first (shard
    # order), evicting 6, then reloads 6
    for shards in ([1], [5], [6], [1], [6, 2]):
        idx = np.concatenate([store.shard_members(s) for s in shards])
        got, want = store.gather(idx), ref.gather(idx)
        for a, b in zip(got, want):
            _equal(a, np.asarray(b))
        first = got[0] if first is None else first
        assert store.cached_shards() == ref.cached_shards()
        assert store.materialized_shards() == ref.materialized_shards()
        assert store.load_count == ref.load_count
    assert store.cached_shards() == (2, 6) and store.load_count == 6
    _equal(store.gather(store.shard_members(1))[0], first)  # a reload gives the same bits
    _raises_same(lambda: ref_pop.ShardedStore(ref.loader, 40, 8, 0),
                 lambda: pop.ShardedStore(store.loader, 40, 8, 0, device="cpu"))


def test_sharded_store_gathers_equal_materialize_store():
    store, ref = _stores(n_clients=48, n_shards=6, max_cached=None, seed=3)
    flat = pop.materialize_store(store)
    assert isinstance(flat, pop.InMemoryStore) and flat.device == store.device
    _equal(store.client_hists(), flat.client_hists())
    idx = np.array([45, 3, 17, 30, 4, 44])  # scattered, unsorted, several shards
    ref_flat = ref_pop.materialize_store(ref)
    for a, b, c in zip(store.gather(idx), flat.gather(idx), ref_flat.gather(idx)):
        _equal(a, b)
        _equal(a, np.asarray(c))
    assert flat.materialized_shards() == tuple(range(6))
    bad = (np.zeros((3, 2)), np.zeros((2, 2)), np.ones((3, 2)), [2, 2, 2], np.ones((3, 4)))
    _raises_same(lambda: ref_pop.InMemoryStore(*bad),
                 lambda: pop.InMemoryStore(*bad, device="cpu"))


# -------------------------------------------------------------- k-medoids
def _separated(n, c, groups, seed):
    """``n`` label histograms around ``groups`` well-separated dominant
    classes (90 % on the group's class)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, groups, n)
    h = rng.dirichlet(np.ones(c), n) * 0.1
    h[np.arange(n), g % c] += 0.9
    return h


@pytest.mark.parametrize("n,k,seed", [(200, 5, 0), (500, 8, 3), (97, 12, 11)])
def test_kmedoids_hists_labels_equal_the_reference(n, k, seed):
    h = _separated(n, 10, k, seed)
    _equal(kmedoids_hists(h, k=k, seed=seed, device="cpu"), ref_kmedoids_hists(h, k=k, seed=seed))


@pytest.mark.parametrize("seed", [0, 5])
def test_kmedoids_hists_given_the_reference_strips_is_exact(seed):
    # mixed histograms, where a last-bit difference of a strip could move a
    # seeding draw: the port's procedure on the reference's own strips
    h = np.random.default_rng(seed).dirichlet(np.ones(10) * 0.5, 300)
    _equal(_kmedoids_hists(h, 9, seed, 25, ref_hellinger_rows),
           ref_kmedoids_hists(h, k=9, seed=seed))


# --------------------------------------------------------------- hierarchy
def _both_stores(n_clients=96, n_shards=8, seed=5):
    kw = dict(seed=seed, n_classes=6, n_features=8)
    return (pop.ShardedStore(pop.SyntheticShardLoader(**kw), n_clients, n_shards, device="cpu"),
            ref_pop.ShardedStore(ref_pop.SyntheticShardLoader(**kw), n_clients, n_shards))


def _selectors(cfg, needs_losses=True, **store_kw):
    store, ref_store = _both_stores(**store_kw)
    return (pop.HierarchicalSelector(PopulationConfig(**cfg), store, seed=0,
                                     needs_losses=needs_losses),
            ref_pop.HierarchicalSelector(ref_pop.PopulationConfig(**cfg), ref_store, seed=0,
                                         needs_losses=needs_losses))


@pytest.mark.parametrize("optics_max", [2048, 16])
def test_hierarchy_shard_labels_equal_the_reference(optics_max, monkeypatch):
    # 16 shards past a limit of 16 run the k-medoids path (k = 8)
    import repro.population.hierarchy as ref_h
    import repro_torch.population.hierarchy as h

    monkeypatch.setattr(h, "_OPTICS_MAX_SHARDS", optics_max)
    monkeypatch.setattr(ref_h, "_OPTICS_MAX_SHARDS", optics_max)
    sel, ref = _selectors({"n_shards": 40, "shards_per_round": 3}, n_clients=400, n_shards=40)
    _equal(sel.shard_labels, ref.shard_labels)
    assert sel.n_shard_clusters == ref.n_shard_clusters > 1


def test_hierarchy_explore_first_observe_and_cohort_equal_the_reference():
    sel, ref = _selectors({"n_shards": 8, "shards_per_round": 2, "j_shards": 2})
    assert np.isinf(sel.estimates).all()
    rng = np.random.default_rng(0)
    seen = set()
    for rnd in range(7):
        (shards, members), (want_s, want_m) = sel.begin_round(rnd), ref.begin_round(rnd)
        _equal(shards, want_s)
        _equal(members, want_m)
        _equal(sel.resident_mask(), ref.resident_mask())
        seen.update(int(s) for s in shards)
        losses = np.full(96, -np.inf, np.float32)
        losses[members] = rng.random(len(members)).astype(np.float32)
        losses[members[:3]] = np.nan if rnd == 2 else losses[members[:3]]
        sel.observe(losses)
        ref.observe(losses)
        _equal(sel.estimates, ref.estimates)
        _equal(sel.select_cohort(losses[members], 5), ref.select_cohort(losses[members], 5))
    assert len(seen) == 8  # +inf estimates explore every shard first


def test_hierarchy_loss_blind_stream_equals_the_reference():
    sel, ref = _selectors({"n_shards": 8, "shards_per_round": 3, "j_shards": 2},
                          needs_losses=False)
    for rnd in range(6):
        _equal(sel.choose_shards(rnd), ref.choose_shards(rnd))
    sel.begin_round(0)
    sel.observe(np.ones(96, np.float32))  # a loss-blind selector keeps no estimates
    assert np.isinf(sel.estimates).all()


def test_hierarchy_state_round_trip_and_one_shard():
    sel, ref = _selectors({"n_shards": 8, "shards_per_round": 2, "j_shards": 2})
    sel.estimates[3] = ref.estimates[3] = 1.25
    assert sel.state_dict() == ref.state_dict()
    other, _ = _selectors({"n_shards": 8, "shards_per_round": 2, "j_shards": 2})
    other.load_state_dict(sel.state_dict())
    _equal(other.estimates, sel.estimates)
    _raises_same(lambda: ref.load_state_dict({"estimates": [1.0]}),
                 lambda: other.load_state_dict({"estimates": [1.0]}))
    with pytest.raises(RuntimeError, match="before begin_round"):
        other.resident_mask()
    one = pop.HierarchicalSelector(PopulationConfig(), pop.materialize_store(
        _both_stores(n_shards=8)[0], n_shards=1), needs_losses=False)
    shards, members = one.begin_round(0)
    _equal(shards, np.array([0]))
    _equal(members, np.arange(96))
    assert one.resident_mask().all()


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("kw", [{"n_shards": 0}, {"n_shards": 4, "shards_per_round": 5},
                                {"shards_per_round": 0}, {"j_shards": 0},
                                {"min_samples": 0}])
def test_population_config_errors_equal_the_reference(kw):
    _raises_same(lambda: ref_pop.PopulationConfig(**kw), lambda: PopulationConfig(**kw))
    _raises_same(lambda: ref_pop.PopulationConfig.from_dict({**kw, "bogus": 1}),
                 lambda: PopulationConfig.from_dict({**kw, "bogus": 1}))


@pytest.mark.parametrize("kw", [
    {"backend": "scaleout"},
    {"backend": "compiled", "fuse_rounds": 2},
    {"async_mode": {"buffer_k": 2}, "systems": {}},
    {"client_mode": "fedprox"},
    {"client_mode": "feddyn", "aggregator": "feddyn"},
    {"population": {"n_shards": 99}},
    {"population": 4},
])
def test_flconfig_population_cross_checks_equal_the_reference(kw):
    full = {"population": {"n_shards": 2}, **kw}
    _raises_same(lambda: fl_cfg(**full), lambda: FLConfig.from_dict({**fl_cfg().to_dict(), **full}))


def test_flconfig_population_normalizes_and_enters_the_fingerprint(data, tmp_path):
    cfg = FLConfig.from_dict(fl_cfg(population={"n_shards": 3, "shards_per_round": 2}).to_dict())
    assert isinstance(cfg.population, PopulationConfig)
    assert FLConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.to_dict() == fl_cfg(population={"n_shards": 3, "shards_per_round": 2}).to_dict()
    train, test = data
    flat = make_engine(FLConfig.from_dict(fl_cfg(rounds=1).to_dict()), train, test, 10,
                       device="cpu")
    flat.save(str(tmp_path / "flat.ckpt"))
    resumed = make_engine(FLConfig.from_dict({**fl_cfg(rounds=1).to_dict(),
                                              "population": {"n_shards": 1}}),
                          train, test, 10, device="cpu")
    with pytest.raises(ValueError, match=r"differing fields: \['population'\]"):
        resumed.restore(str(tmp_path / "flat.ckpt"))


# ------------------------------------------------------------------ engine
def _port(data, draws=None, **kw):
    train, test = data
    cfg = FLConfig.from_dict(fl_cfg(**kw).to_dict())
    return make_engine(cfg, train, test, 10, device="cpu", draws=draws)


@pytest.mark.parametrize("backend", ["host", "compiled"])
@pytest.mark.parametrize("strategy", ["fedlecc", "random", "lossonly"])
def test_one_shard_population_gives_the_flat_engines_bits(strategy, backend, data):
    kw = {"strategy_kwargs": {"J": 3}} if strategy == "fedlecc" else {}
    flat = _port(data, strategy=strategy, backend=backend, rounds=2, **kw)
    one = _port(data, strategy=strategy, backend=backend, rounds=2,
                population={"n_shards": 1}, **kw)
    for a, b in zip(flat.rounds(), one.rounds(), strict=True):
        assert (a.selected, a.mean_selected_loss, a.test_loss, a.test_acc, a.comm_mb) == \
            (b.selected, b.mean_selected_loss, b.test_loss, b.test_acc, b.comm_mb)
    assert torch.equal(flat.params, one.params)


def _against_reference(data, **kw):
    """``fl_cfg(**kw)`` in the reference's engine and in the port's under
    ``JaxReplayDraws``, round by round."""
    train, test = data
    ref_cfg = fl_cfg(**kw)
    ref_eng = ref_make_engine(ref_cfg, train, test, n_classes=10)
    cfg = FLConfig.from_dict(ref_cfg.to_dict())
    eng = make_engine(cfg, train, test, 10, device="cpu",
                      draws=JaxReplayDraws(cfg.seed, "cpu", n_clients=cfg.n_clients))
    _equal(eng._population.shard_labels, ref_eng._population.shard_labels)
    assert eng.m_eff == ref_eng.m_eff
    results = []
    for got, want in zip(eng.rounds(), ref_eng.rounds(), strict=True):
        results.append(got)
        _equal(eng._pop_members, ref_eng._pop_members)
        # the shard estimates are means of polled losses: the losses' tolerance
        np.testing.assert_allclose(eng._population.estimates, ref_eng._population.estimates,
                                   rtol=0, atol=1e-4)
        for f in ("round", "selected", "comm_mb", "n_dropped", "sim_time", "n_faulty",
                  "n_quarantined"):
            assert getattr(got, f) == getattr(want, f), (f, got.round)
        assert abs(got.mean_selected_loss - want.mean_selected_loss) <= 1e-4
        assert abs(got.test_loss - want.test_loss) <= 1e-4
        want_p = params_from_jax(jax.tree.map(np.asarray, ref_eng.params)).numpy()
        np.testing.assert_allclose(eng.params.numpy(), want_p, atol=1e-5)
    return eng, results


@pytest.mark.parametrize("backend", ["host", "compiled"])
def test_partial_residency_matches_the_reference(backend, data):
    eng, results = _against_reference(data, backend=backend, rounds=3, population=POP)
    assert len(eng._pop_members) < eng.cfg.n_clients  # residency is partial


def test_population_with_both_axes_matches_the_reference(data):
    axes = dict(systems={"profile": "mobile_mix", "availability": "bernoulli",
                         "availability_kwargs": {"p": 0.8}, "over_select": 1.25},
                faults={"rate": 0.3, "models": ["sign_flip"], "defense": "validate"})
    eng, results = _against_reference(data, rounds=3, population={**POP, "shards_per_round": 3},
                                      **axes)
    assert sum(r.n_faulty for r in results) > 0
    # the compiled backend keeps the host's survivors, drops and flags
    host = _port(data, rounds=3, population={**POP, "shards_per_round": 3}, **axes)
    comp = _port(data, rounds=3, population={**POP, "shards_per_round": 3}, backend="compiled",
                 **axes)
    for a, b in zip(host.rounds(), comp.rounds(), strict=True):
        assert (a.selected, a.n_dropped, a.n_faulty, a.n_quarantined, a.comm_mb) == \
            (b.selected, b.n_dropped, b.n_faulty, b.n_quarantined, b.comm_mb)
    np.testing.assert_allclose(host.params.numpy(), comp.params.numpy(), atol=1e-5)


@pytest.mark.parametrize("backend", ["host", "compiled"])
def test_cohort_stays_inside_the_resident_shards(backend, data):
    eng = _port(data, backend=backend, rounds=3, population=POP)
    for r in eng.rounds():
        members = set(int(i) for i in eng._pop_members)
        assert set(r.selected) <= members and len(members) < eng.cfg.n_clients


def test_ledger_bills_resident_polls_only(data):
    flat = [r.comm_mb for r in _port(data, rounds=2).rounds()]
    part = [r.comm_mb for r in _port(data, rounds=2, population=POP).rounds()]
    assert all(p < f for p, f in zip(part, flat))
    # 2 rounds x 6 clients outside the resident shards, 4 bytes each
    np.testing.assert_allclose(flat[-1] - part[-1], 2 * 6 * 4 / 2**20, rtol=1e-6)


@pytest.mark.parametrize("backend", ["host", "compiled"])
def test_kill_and_resume_is_bit_identical(backend, data, tmp_path):
    kw = dict(backend=backend, rounds=4, population={**POP, "n_shards": 3})
    whole = _port(data, **kw)
    want = list(whole.rounds())
    eng = _port(data, **kw)
    it = eng.rounds()
    next(it)
    next(it)
    eng.save(str(tmp_path / "pop.ckpt"))
    del eng, it
    train, test = data
    resumed = make_engine(whole.cfg, train, test, 10, device="cpu",
                          resume=str(tmp_path / "pop.ckpt"))
    assert np.isfinite(resumed._population.estimates).sum() > 0
    got = list(resumed.rounds())
    assert [(r.selected, r.comm_mb, r.test_loss) for r in got] == \
        [(r.selected, r.comm_mb, r.test_loss) for r in want[2:]]
    assert torch.equal(resumed.params, whole.params)
    _equal(resumed._population.estimates, whole._population.estimates)


def test_undersized_resident_shards_are_refused_as_the_reference_does(data):
    train, test = data
    kw = dict(m=8, population={"n_shards": 6, "shards_per_round": 1})
    _raises_same(lambda: ref_make_engine(fl_cfg(**kw), train, test, n_classes=10),
                 lambda: _port(data, **kw))
    with pytest.raises(ValueError, match="cohort_gather=False"):
        make_engine(FLConfig.from_dict(fl_cfg(backend="compiled", population=POP).to_dict()),
                    train, test, 10, device="cpu", cohort_gather=False)


@pytest.mark.parametrize("backend", ["host", "compiled"])
def test_population_engine_holds_no_population_sized_stack(backend, data):
    eng = _port(data, backend=backend, population=POP)
    n_max = eng._store._mask.shape[1]
    assert eng.xs is None and eng.ys is None and eng.draws._rows is None
    # only the host-side row-sampling probabilities are (K, N_max)
    stacks = {k for k, v in vars(eng).items()
              if isinstance(v, torch.Tensor) and v.ndim >= 2 and v.shape[:2] == (12, n_max)}
    assert stacks == {"sample_probs"} and eng.sample_probs.device.type == "cpu"
    assert not any(isinstance(t, torch.Tensor) for t in (eng._store._xs, eng._store._ys))
    next(eng.rounds())
    assert eng.draws._rows is None
