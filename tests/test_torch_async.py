"""The port's async runtime (``FLConfig.async_mode``) against the reference's
``repro.engine.async_engine`` and ``async_config``, on the CPU.

- ``AsyncConfig`` and ``FLConfig`` raise the reference's errors, message
  for message, and round-trip through ``to_dict`` / ``from_dict``; the
  discounts, ``staleness_weights`` and ``arrival_order`` equal the
  reference's on the same arrays.
- Under ``JaxReplayDraws`` (the reference's key chain, the d-th dispatch
  drawing the d-th split) the port's ``AsyncHostEngine`` and
  ``AsyncCompiledEngine`` match the reference's step for step: ``selected``,
  ``params_version``, ``staleness``, ``n_dropped``, ``sim_clock``,
  ``comm_mb`` and the fault counts exactly (under the validation gate the
  flagged sets too: the norms differ by fp32 rounding only, far from the
  threshold here), the params within 1e-5 (the reference's own host-vs-
  compiled bar; the port sums the kept deltas in one K1 reduce where the
  reference sums group by group).
- ``dispatch="sync"`` is the lock-step engine, bit for bit; a run killed
  mid-buffer resumes bit-identically; fedcs drives the runtime; a fetched
  snapshot survives the aggregations after it; the ledger keeps only
  pending rows; K1 runs once a step that applies an update.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from conftest import fl_cfg  # noqa: E402
from test_torch_engine import JaxReplayDraws  # noqa: E402

from repro.engine import AsyncConfig as RefAsyncConfig  # noqa: E402
from repro.engine import make_engine as ref_make_engine  # noqa: E402
from repro.engine import async_config as ref_async_config  # noqa: E402
from repro.engine.registry import list_staleness_discounts as ref_discounts  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    AsyncCompiledEngine,
    AsyncConfig,
    AsyncHostEngine,
    FLConfig,
    make_engine,
)
from repro_torch.engine import async_config  # noqa: E402
from repro_torch.engine import async_engine  # noqa: E402
from repro_torch.engine.registry import list_staleness_discounts  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sys(**over):
    base = dict(profile="mobile_mix", availability="markov",
                availability_kwargs={"p_drop": 0.2, "p_join": 0.6}, jitter_sigma=0.1)
    if "availability" in over and "availability_kwargs" not in over:
        base["availability_kwargs"] = {}
    base.update(over)
    return base


def _ref_cfg(**kw):
    kw.setdefault("systems", _sys())
    kw.setdefault("async_mode", {"buffer_k": 3, "concurrency": 8})
    kw.setdefault("rounds", 6)
    kw.setdefault("eval_every", 2)
    return fl_cfg(**kw)


def _cfg(**kw):
    return FLConfig.from_dict(_ref_cfg(**kw).to_dict())


def _engine(data, **kw):
    train, test = data
    return make_engine(_cfg(**kw), train, test, 10, device="cpu")


# ---------------------------------------------------------------- config
def _errors(fn_ours, fn_ref):
    with pytest.raises(Exception) as ours:
        fn_ours()
    with pytest.raises(Exception) as theirs:
        fn_ref()
    assert type(ours.value) is type(theirs.value)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kw", [
    {"dispatch": "eventually"}, {"buffer_k": 0}, {"buffer_k": 2.5}, {"concurrency": -1},
    {"staleness": "logarithmic"}, {"max_staleness": -2}, {"staleness_kwargs": [1]},
    {"staleness_kwargs": {"factor": -1.0}}, {"staleness": "polynomial",
                                             "staleness_kwargs": {"exponent": 2.0}},
])
def test_async_config_field_errors_match_reference(kw):
    _errors(lambda: AsyncConfig(**kw), lambda: RefAsyncConfig(**kw))


def test_async_config_helpers_match_reference():
    _errors(lambda: AsyncConfig.from_dict({"buffer_k": 2, "bogus": 1}),
            lambda: RefAsyncConfig.from_dict({"buffer_k": 2, "bogus": 1}))
    for kw in ({}, {"buffer_k": 3}, {"buffer_k": 3, "concurrency": 11},
               {"staleness": "polynomial"}, {"staleness_kwargs": {"factor": 0.5}}):
        a, b = AsyncConfig(**kw), RefAsyncConfig(**kw)
        for m in (1, 4, 10):
            assert a.buffer_effective(m) == b.buffer_effective(m)
            assert a.concurrency_effective(m) == b.concurrency_effective(m)
        assert a.discount_off() == b.discount_off()
    assert list_staleness_discounts() == ref_discounts()


# (FLConfig keyword arguments; the reference's own combination cases)
COMBINATIONS = {
    "fused": dict(backend="compiled", fuse_rounds=2, async_mode={"buffer_k": 3}),
    "aggregator": dict(aggregator="fednova", async_mode={"buffer_k": 3}),
    "client_mode": dict(client_mode="fedprox", mu=0.1, async_mode={"buffer_k": 3}),
    "compress": dict(backend="compiled", compress_bits=8, async_mode={"buffer_k": 3}),
    "no_systems": dict(systems=None, async_mode={"buffer_k": 3}),
    "deadline": dict(systems=_sys(deadline_s=30.0), async_mode={"buffer_k": 3}),
    "concurrency": dict(async_mode={"buffer_k": 3, "concurrency": 2}),
    "population": dict(async_mode={"buffer_k": 50}),
    "sync_buffer": dict(async_mode={"dispatch": "sync", "buffer_k": 2}),
    "type": dict(async_mode=42),
    "energy": dict(systems=_sys(track_energy=True), async_mode={"buffer_k": 3}),
}


@pytest.mark.parametrize("case", list(COMBINATIONS))
def test_flconfig_async_errors_match_reference(case):
    kw = COMBINATIONS[case]
    _errors(lambda: _cfg(**kw), lambda: _ref_cfg(**kw))


def test_flconfig_accepts_and_round_trips_async_mode():
    _cfg(systems=_sys(deadline_s=30.0), async_mode={"dispatch": "sync"})
    cfg = _cfg(async_mode={"buffer_k": 3, "concurrency": 8, "staleness": "polynomial",
                           "staleness_kwargs": {"a": 0.5}, "max_staleness": 4})
    assert isinstance(cfg.async_mode, AsyncConfig)
    d = json.loads(json.dumps(cfg.to_dict()))
    assert isinstance(d["async_mode"], dict)
    assert d == json.loads(json.dumps(_ref_cfg(**{"async_mode": d["async_mode"]}).to_dict()))
    restored = FLConfig.from_dict(d)
    assert restored == cfg and isinstance(restored.async_mode, AsyncConfig)
    assert FLConfig().to_dict()["async_mode"] is None


# ----------------------------------------------------- the pure cores
@pytest.mark.parametrize("name,kw", [("constant", {}), ("constant", {"factor": 0.25}),
                                     ("polynomial", {}), ("polynomial", {"a": 1.0}),
                                     ("exponential", {"gamma": 0.5}), ("exponential", {})])
def test_discounts_and_weights_match_reference(name, kw):
    rng = np.random.default_rng(len(name) + len(kw))
    stal = rng.integers(0, 9, 12)
    sizes = rng.integers(1, 200, 12).astype(np.float64)
    ours = async_config.make_staleness_discount(name, **kw)
    ref = ref_async_config.make_staleness_discount(name, **kw)
    np.testing.assert_array_equal(ours(stal), ref(stal))
    for max_s in (None, 0, 3, 100):
        np.testing.assert_array_equal(
            async_config.staleness_weights(sizes, stal, ours, max_s),
            ref_async_config.staleness_weights(sizes, stal, ref, max_s))
    reached = rng.random(12) < 0.7
    arrival = np.round(rng.random(12), 1)  # ties broken by client index
    np.testing.assert_array_equal(async_config.arrival_order(np.arange(12), reached, arrival),
                                  ref_async_config.arrival_order(np.arange(12), reached,
                                                                 arrival))
    _errors(lambda: async_config.staleness_weights(np.ones(3), np.zeros(2, np.int64), ours),
            lambda: ref_async_config.staleness_weights(np.ones(3), np.zeros(2, np.int64), ref))


# ------------------------------------------------ against the reference
FIELDS = ("round", "selected", "params_version", "staleness", "n_dropped", "sim_time",
          "sim_clock", "comm_mb", "n_faulty", "n_quarantined", "evaluated")
VALIDATE = {"rate": 0.3, "models": ["sign_flip", "nan_update"], "defense": "validate"}
REF_CASES = {
    "host": dict(backend="host", async_mode={"buffer_k": 3, "concurrency": 8,
                                             "staleness": "polynomial"}),
    "compiled": dict(backend="compiled", async_mode={"buffer_k": 3, "concurrency": 8,
                                                     "staleness": "polynomial"}),
    "host_faults": dict(backend="host", faults=VALIDATE),
    "compiled_faults": dict(backend="compiled", faults=VALIDATE),
    "host_max_staleness": dict(backend="host", strategy="random",
                               async_mode={"buffer_k": 2, "concurrency": 8,
                                           "staleness": "exponential", "max_staleness": 1}),
}


@pytest.mark.parametrize("case", list(REF_CASES))
def test_async_rounds_match_reference(data, case):
    train, test = data
    ref_cfg = _ref_cfg(**REF_CASES[case])
    ref = ref_make_engine(ref_cfg, train, test, 10)
    ref_res = list(ref.rounds())
    cfg = FLConfig.from_dict(ref_cfg.to_dict())
    eng = make_engine(cfg, train, test, 10, device="cpu", draws=JaxReplayDraws(cfg.seed, "cpu"))
    assert type(eng) is (AsyncCompiledEngine if cfg.backend == "compiled" else AsyncHostEngine)
    res = list(eng.rounds())
    for field in FIELDS:
        assert [getattr(r, field) for r in res] == [getattr(r, field) for r in ref_res], field
    for a, b in zip(res, ref_res):
        if a.evaluated:
            assert abs(a.test_loss - b.test_loss) < 1e-4
    want = params_from_jax(jax.tree.map(np.asarray, ref.params)).numpy()
    np.testing.assert_allclose(eng.params.numpy(), want, rtol=0, atol=1e-5)
    if cfg.faults is not None:
        assert sum(r.n_faulty for r in res) > 0
        assert max(r.n_quarantined for r in res) > 0  # the gate flagged someone
        np.testing.assert_array_equal(eng._faults.health.total_faults,
                                      np.asarray(ref._faults.health.total_faults))


# ------------------------------------------------------- port contracts
@pytest.mark.parametrize("backend", ["host", "compiled"])
def test_sync_dispatch_is_the_lock_step_engine(backend, data):
    kw = dict(backend=backend, rounds=4, systems=_sys(deadline_s=30.0, over_select=1.3))
    train, test = data
    sync = make_engine(FLConfig.from_dict(fl_cfg(eval_every=2, **kw).to_dict()), train, test,
                       10, device="cpu")
    dgen = _engine(data, async_mode={"dispatch": "sync"}, **kw)
    rs, rd = list(sync.rounds()), list(dgen.rounds())
    for a, b in zip(rs, rd):
        assert (a.selected, a.comm_mb, a.sim_clock, a.sim_time, a.n_dropped) == \
            (b.selected, b.comm_mb, b.sim_clock, b.sim_time, b.n_dropped)
        assert b.staleness == 0.0 and b.params_version == a.round + 1
    assert json.dumps(sync.history) == json.dumps(dgen.history)
    assert torch.equal(sync.params, dgen.params)


@pytest.mark.parametrize("case", ["host", "compiled", "host_faults"])
def test_kill_and_resume_mid_buffer_bit_identical(case, data, tmp_path):
    kw = dict(backend="compiled" if case == "compiled" else "host", rounds=8)
    if case == "host_faults":
        kw["faults"] = {**VALIDATE, "models": VALIDATE["models"] + ["stale_replay"]}
    ref = _engine(data, **kw)
    ref_res = list(ref.rounds())
    killed = _engine(data, **kw)
    it = killed.rounds()
    pre = [next(it) for _ in range(4)]
    it.close()
    assert killed._ledger and killed._n_inflight() > 0  # really mid-buffer
    path = str(tmp_path / "async.ckpt")
    killed.save(path)
    resumed = _engine(data, **kw)
    resumed.restore(path)
    assert (resumed._round, resumed._version, resumed._dispatches, resumed._n_inflight()) == \
        (4, killed._version, killed._dispatches, killed._n_inflight())
    post = list(resumed.rounds())
    for field in FIELDS:
        assert [getattr(r, field) for r in pre + post] == [getattr(r, field) for r in ref_res]
    assert json.dumps(resumed.history) == json.dumps(ref.history)
    assert torch.equal(resumed.params, ref.params)


def test_async_restore_rejects_foreign_checkpoints(data, tmp_path):
    train, test = data
    sync_cfg = FLConfig.from_dict(fl_cfg(systems=_sys()).to_dict())
    sync_path = str(tmp_path / "sync.ckpt")
    make_engine(sync_cfg, train, test, 10, device="cpu").save(sync_path)
    with pytest.raises(ValueError, match="no async ledger"):
        _engine(data).restore(sync_path)
    eng = _engine(data)
    it = eng.rounds()
    next(it)
    it.close()
    async_path = str(tmp_path / "async.ckpt")
    eng.save(async_path)
    with pytest.raises(ValueError):
        make_engine(sync_cfg, train, test, 10, device="cpu").restore(async_path)


def test_async_compiled_requires_cohort_gather(data):
    train, test = data
    with pytest.raises(ValueError, match="cohort_gather"):
        make_engine(_cfg(backend="compiled"), train, test, 10, device="cpu",
                    cohort_gather=False)


def test_fedcs_drives_the_async_runtime(data):
    """The predicted-time strategy inside the scheduler: it polls no
    losses, dispatches the fastest idle clients, and drains its buffer
    faster than fedlecc under the same profile."""
    rf, rs = list(_engine(data, strategy="fedcs").rounds()), list(_engine(data).rounds())
    assert all(r.selected for r in rf)
    assert rf[-1].sim_clock < rs[-1].sim_clock
    assert rf[-1].comm_mb < rs[-1].comm_mb


def test_fetched_params_survive_aggregation_and_ledger_keeps_pending_rows(data, monkeypatch):
    """(a) Every update of the params rebinds them, so the params a cohort
    trained against are still the params of its version after later
    aggregations; (b) the ledger holds exactly the pending rows, never
    more than ``concurrency``; (c) K1 runs once a step that applies an
    update, over the kept entries."""
    calls = []
    real = async_engine.masked_weighted_sum
    monkeypatch.setattr(async_engine, "masked_weighted_sum",
                        lambda x, w: (calls.append(tuple(x.shape)), real(x, w))[1])
    eng = _engine(data, rounds=10, async_mode={"buffer_k": 2, "concurrency": 8,
                                               "staleness": "polynomial"})
    at_version = {0: eng.params.clone()}
    applied = older = 0
    for r in eng.rounds():
        at_version[r.params_version] = eng.params.clone()
        applied += bool(r.selected)
        for g in eng._ledger:
            assert g.stacked.shape[0] == int(g.pending.sum())
            assert np.array_equal(np.flatnonzero(g.rows >= 0), np.flatnonzero(g.pending))
        assert eng._n_inflight() <= eng._concurrency
        assert set(eng._fetched) == {g.version for g in eng._ledger}
        for v, fetched in eng._fetched.items():
            assert torch.equal(fetched, at_version[v]), v
            older += v < eng._version
    assert older > 0  # some fetched params outlived aggregations
    assert applied == len(calls) > 0
    assert all(shape[0] <= 2 and shape[1] == eng.n_params for shape in calls)
