"""The systems axis of the port (``repro_torch.systems``, ``FLConfig.systems``)
against the reference's ``repro.systems``.

- Module parity, exact: ``SystemsConfig`` validation (message for
  message), its dict round trip and ``m_effective``; every profile preset
  and availability model (``TraceAvailability`` from CSV and JSON too) over
  20 rounds; ``RoundClock``'s times, ``arrived``, ``round_outcome``,
  ``SystemsRuntime`` and its energy ledger — the port keeps the
  reference's numpy streams, so every value is the same bit for bit.
- Engine parity under ``JaxReplayDraws`` (the reference's draws): the
  port's ``HostEngine`` against the reference's on the tiny classification
  config, 3 rounds: the same survivors, ``n_dropped``, ``sim_time``,
  ``sim_clock`` and ``comm_mb`` exactly, params within 1e-5 every round
  (fp32 sums in other orders, as ``tests/test_torch_engine.py``).
- The reference's backend contracts (``tests/test_systems.py``) under the
  port's ``TorchDraws``: availability-gated masks identical across host,
  compiled and fused; the inert config equal to the frictionless engine
  bit for bit; over-selection; a no-upload round; HACCS on the profile's
  latency; a deadline beating the no-deadline clock; a trace schedule."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from conftest import fl_cfg  # noqa: E402
from test_torch_engine import JaxReplayDraws  # noqa: E402

import repro.systems as ref_sys  # noqa: E402
from repro.engine import make_engine as ref_make_engine  # noqa: E402
from repro.systems.runtime import SystemsRuntime as RefSystemsRuntime  # noqa: E402
import repro_torch.systems as sys_  # noqa: E402
from repro_torch.convert import params_from_jax, transformer_params_from_jax  # noqa: E402
from repro_torch.engine import FLConfig, SystemsConfig, make_engine  # noqa: E402
from repro_torch.systems.runtime import SystemsRuntime  # noqa: E402


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


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("kw", [
    {"profile": "datacenter"}, {"availability": "solar_flare"}, {"over_select": 0.5},
    {"over_select": float("inf")}, {"deadline_s": 0.0}, {"jitter_sigma": -1.0},
    {"profile_kwargs": []},
])
def test_systems_config_rejects_what_the_reference_rejects(kw):
    _raises_same(lambda: ref_sys.SystemsConfig(**kw), lambda: SystemsConfig(**kw))


def test_systems_config_round_trip_and_m_effective():
    _raises_same(lambda: ref_sys.SystemsConfig.from_dict({"bogus": 1}),
                 lambda: SystemsConfig.from_dict({"bogus": 1}))
    kw = dict(profile="mobile_mix", availability="markov",
              availability_kwargs={"p_drop": 0.2, "p_join": 0.6}, deadline_s=30,
              over_select=1.3, jitter_sigma=0.2, track_energy=1)
    ref, port = ref_sys.SystemsConfig(**kw), SystemsConfig(**kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    cfg = FLConfig.from_dict(json.loads(json.dumps(fl_cfg(systems=ref).to_dict())))
    assert cfg.systems == port and cfg.to_dict() == fl_cfg(systems=ref).to_dict()
    for over in (1.0, 1.3, 1.5, 1.6, 2.0, 12.0):
        for m, k in ((10, 100), (4, 12), (10, 12), (1, 1)):
            assert (SystemsConfig(over_select=over).m_effective(m, k)
                    == ref_sys.SystemsConfig(over_select=over).m_effective(m, k))


# ------------------------------------------------------ profiles, traces
def _profile_arrays(p):
    return [np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)]


@pytest.mark.parametrize("name,kw", [
    ("uniform", {}), ("uniform", {"speed": 3.0, "down": 7.0, "up": 2.5}),
    ("zipf_compute", {}), ("zipf_compute", {"exponent": 1.7, "base_speed": 9.0}),
    ("mobile_mix", {}), ("mobile_mix", {"fractions": (0.5, 0.0, 0.5), "scatter": 0.0}),
])
@pytest.mark.parametrize("seed", [0, 7])
def test_profiles_equal_the_reference(name, kw, seed):
    assert sys_.list_profiles() == ref_sys.list_profiles()
    got, want = sys_.make_profile(name, 50, seed=seed, **kw), ref_sys.make_profile(name, 50,
                                                                                   seed=seed, **kw)
    for a, b in zip(_profile_arrays(got), _profile_arrays(want), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _trace_files(tmp_path, k):
    rows = np.random.default_rng(3).random((7, k)) < 0.6
    csv = tmp_path / "sched.csv"
    csv.write_text("# a schedule\n" + "\n".join(",".join(str(int(v)) for v in r)
                                                for r in rows) + "\n")
    js = tmp_path / "sched.json"
    js.write_text(json.dumps({"rounds": rows.astype(int).tolist()}))
    return str(csv), str(js)


@pytest.mark.parametrize("name,kw", [
    ("always", {}), ("bernoulli", {}), ("bernoulli", {"p": 0.3}), ("markov", {}),
    ("markov", {"p_drop": 0.4, "p_join": 0.2}), ("trace-csv", {}), ("trace-json", {}),
    ("trace-csv", {"wrap": False}),
])
def test_availability_models_equal_the_reference_over_20_rounds(name, kw, tmp_path):
    assert sys_.list_availability_models() == ref_sys.list_availability_models()
    k = 40
    if name.startswith("trace"):
        csv, js = _trace_files(tmp_path, k)
        kw = {**kw, "path": csv if name == "trace-csv" else js}
        name = "trace"
    got = sys_.make_availability(name, k, seed=5, **kw)
    want = ref_sys.make_availability(name, k, seed=5, **kw)
    order = list(range(20))[::-1] if name == "markov" else range(20)  # out of order first
    for t in order:
        a, b = got.mask(t), want.mask(t)
        assert a.dtype == b.dtype == bool and np.array_equal(a, b), t
    for bad in ({"p_drop": 1.5} if name == "markov" else None,
                {"p": 0.0} if name == "bernoulli" else None):
        if bad:
            _raises_same(lambda: ref_sys.make_availability(name, 4, **bad),
                         lambda: sys_.make_availability(name, 4, **bad))


def test_trace_availability_rejects_what_the_reference_rejects(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text("1,2\n0,1\n")
    two = tmp_path / "two.json"
    two.write_text(json.dumps({"rounds": [[1, 0], [0, 1]]}))
    for path, k in ((bad, 2), (two, 5), (tmp_path / "x.txt", 2)):
        _raises_same(lambda: ref_sys.make_availability("trace", k, path=str(path)),
                     lambda: sys_.make_availability("trace", k, path=str(path)))


@pytest.mark.parametrize("sigma", [0.0, 0.3])
def test_round_clock_and_round_outcome_equal_the_reference(sigma):
    prof, ref_prof = sys_.make_profile("mobile_mix", 30, 2), ref_sys.make_profile("mobile_mix",
                                                                                   30, 2)
    steps = np.random.default_rng(0).integers(1, 50, 30)
    clock = sys_.RoundClock(prof, 0.76, 0.19, steps, jitter_sigma=sigma, seed=4)
    ref = ref_sys.RoundClock(ref_prof, 0.76, 0.19, steps, jitter_sigma=sigma, seed=4)
    assert np.array_equal(clock.base_times(), ref.base_times())
    rng = np.random.default_rng(1)
    for t in range(20):
        times = clock.times(t)
        assert np.array_equal(times, ref.times(t))
        sel = np.sort(rng.choice(30, size=8, replace=False))
        avail = rng.random(30) < 0.8
        for deadline in (None, float(np.median(times)), 1e-9):
            got = sys_.round_outcome(sel, avail, times, deadline)
            want = ref_sys.round_outcome(sel, avail, times, deadline)
            assert np.array_equal(got.survivors, want.survivors)
            assert (got.n_dispatched, got.n_reached, got.n_dropped, got.sim_time) == (
                want.n_dispatched, want.n_reached, want.n_dropped, want.sim_time)


def test_systems_runtime_and_energy_ledger_equal_the_reference():
    kw = dict(profile="zipf_compute", availability="markov",
              availability_kwargs={"p_drop": 0.3, "p_join": 0.5}, deadline_s=1.5,
              jitter_sigma=0.2, track_energy=True)
    steps = np.random.default_rng(2).integers(1, 60, 24)
    args = dict(n_clients=24, steps=steps, n_params=199_210, upload_bytes_per_param=1.0,
                seed=3)
    rt = SystemsRuntime(SystemsConfig(**kw), **args)
    ref = RefSystemsRuntime(ref_sys.SystemsConfig(**kw), **args)
    assert np.array_equal(rt.latency_hint(), ref.latency_hint())
    rng = np.random.default_rng(4)
    for t in range(20):
        for name in ("available", "times", "arrived"):
            assert np.array_equal(getattr(rt, name)(t), getattr(ref, name)(t)), (name, t)
        sel = np.sort(rng.choice(24, size=9, replace=False))
        got, want = rt.outcome(t, sel), ref.outcome(t, sel)
        assert np.array_equal(got.survivors, want.survivors) and got.sim_time == want.sim_time
        mask = np.zeros(24, bool)
        mask[sel] = True
        from_mask = rt.outcome_from_mask(t, mask)
        assert np.array_equal(from_mask.survivors, got.survivors)
        assert (from_mask.n_reached, from_mask.sim_time) == (got.n_reached, got.sim_time)
        assert rt.spend_energy(t, sel) == ref.spend_energy(t, sel)
        assert np.array_equal(rt.battery_mah, ref.battery_mah)
    assert rt.state_dict() == ref.state_dict()
    fresh = SystemsRuntime(SystemsConfig(**kw), **args)
    fresh.load_state_dict(ref.state_dict())
    assert np.array_equal(fresh.battery_mah, ref.battery_mah)
    with pytest.raises(ValueError, match="battery"):
        fresh.load_state_dict({})
    plain = SystemsRuntime(SystemsConfig(), **args)
    assert plain.state_dict() == {}
    with pytest.raises(ValueError, match="carries no state"):
        plain.load_state_dict({"battery_mah": [1.0]})


# ----------------------------------------- engine parity under the reference's draws
_SYS = dict(profile="zipf_compute", availability="bernoulli", availability_kwargs={"p": 0.7},
            deadline_s=2.0, over_select=1.5, jitter_sigma=0.1)
ENGINE_CASES = {
    "deadline_over_select": {"systems": _SYS},
    "markov": {"systems": {**_SYS, "availability": "markov",
                           "availability_kwargs": {"p_drop": 0.4, "p_join": 0.4}}},
    "energy_fedcs": {"strategy": "fedcs", "systems": {**_SYS, "profile": "mobile_mix",
                                                       "track_energy": True}},
}


def check_rounds_against_reference(data, ref_cfg, n_classes=10, resync=False):
    """``ref_cfg`` (a reference ``FLConfig``) in the reference's
    ``HostEngine`` and in the port's under ``JaxReplayDraws``, round by
    round: the axes' fields and ``comm_mb`` exactly, params within 1e-5;
    with ``resync`` the port starts each round from the reference's
    parameters (the xLSTM rule, ``tests/test_torch_xlstm.py``)."""
    train, test = data
    ref_eng = ref_make_engine(ref_cfg, train, test, n_classes=n_classes)
    cfg = FLConfig.from_dict(ref_cfg.to_dict())
    eng = make_engine(cfg, train, test, n_classes, device="cpu",
                      draws=JaxReplayDraws(cfg.seed, "cpu"))
    mc = getattr(eng.task, "model_cfg", None)

    def flat(e):
        tree = jax.tree.map(np.asarray, e.params)
        return params_from_jax(tree) if mc is None else transformer_params_from_jax(tree, mc)

    assert eng.m_eff == ref_eng.m_eff
    ref_it, it = ref_eng.rounds(), eng.rounds()
    results = []
    for _ in range(ref_cfg.rounds):
        if resync:
            eng.params = flat(ref_eng)
        want, got = next(ref_it), next(it)
        results.append(got)
        for f in ("round", "selected", "n_dropped", "sim_time", "sim_clock", "n_faulty",
                  "n_quarantined", "comm_mb", "params_version"):
            assert getattr(got, f) == getattr(want, f), (f, got.round)
        assert abs(got.mean_selected_loss - want.mean_selected_loss) <= 1e-4 or (
            np.isnan(got.mean_selected_loss) and np.isnan(want.mean_selected_loss))
        if want.evaluated:
            assert abs(got.test_loss - want.test_loss) <= 1e-4
        if want.metrics is not None:  # the energy ledger (numpy) exactly, ppl to 1e-4
            for k, v in want.metrics.items():
                if k.startswith(("energy", "n_depleted")):
                    assert got.metrics[k] == v, k
                elif isinstance(v, float):
                    assert got.metrics[k] == pytest.approx(v, rel=1e-4), k
        np.testing.assert_allclose(eng.params.numpy(), flat(ref_eng).numpy(), atol=1e-5)
    assert next(it, None) is None and next(ref_it, None) is None
    assert {k: eng.history[k] for k in ref_eng.history if k in ("selected", "sim_clock",
                                                                 "n_dropped", "n_faulty",
                                                                 "n_quarantined")} == {
        k: ref_eng.history[k] for k in ref_eng.history if k in ("selected", "sim_clock",
                                                                 "n_dropped", "n_faulty",
                                                                 "n_quarantined")}
    assert set(eng.history) == set(ref_eng.history)
    return results


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_host_rounds_match_the_reference_under_systems(data, name):
    rs = check_rounds_against_reference(data, fl_cfg(**ENGINE_CASES[name]))
    if name != "energy_fedcs":
        assert sum(r.n_dropped for r in rs) > 0  # the deadline or availability bites
    else:
        assert all(r.metrics["energy_mah"] > 0 for r in rs)


# ---------------------------------------- the reference's contracts, TorchDraws
def _engine(data, **kw):
    train, test = data
    return make_engine(FLConfig.from_dict(fl_cfg(**kw).to_dict()), train, test, 10,
                       device="cpu")


_ALWAYS = {**_SYS, "availability": "always", "availability_kwargs": {}, "jitter_sigma": 0.0}
BACKENDS = {"host": {}, "compiled": {"backend": "compiled"},
            "fused": {"backend": "compiled", "fuse_rounds": 3}}


@pytest.mark.parametrize("availability", ["bernoulli", "markov"])
def test_availability_gated_masks_identical_across_backends(availability, data):
    kw = dict(strategy="fedlecc", strategy_kwargs={"J": 3}, rounds=6, eval_every=2,
              systems=ENGINE_CASES["markov" if availability == "markov"
                                   else "deadline_over_select"]["systems"])
    runs = {}
    for name, extra in BACKENDS.items():
        eng = _engine(data, **kw, **extra)
        runs[name] = (list(eng.rounds(6)), eng.params)
    ref, ref_params = runs["host"]
    assert any(r.n_dropped > 0 for r in ref)
    for name in ("compiled", "fused"):
        rs, params = runs[name]
        for a, b in zip(ref, rs, strict=True):
            assert (a.selected, a.n_dropped, a.sim_time, a.sim_clock, a.comm_mb) == (
                b.selected, b.n_dropped, b.sim_time, b.sim_clock, b.comm_mb), (name, a.round)
            assert a.mean_selected_loss == pytest.approx(b.mean_selected_loss, rel=1e-4,
                                                         nan_ok=True)
        assert float((ref_params - params).abs().max()) < 1e-5


@pytest.mark.parametrize("backend", ["host", "compiled", "fused"])
def test_inert_systems_matches_frictionless_engine(backend, data):
    plain = _engine(data, **BACKENDS[backend])
    inert = _engine(data, systems={}, **BACKENDS[backend])
    for a, b in zip(list(plain.rounds(3)), list(inert.rounds(3)), strict=True):
        assert a.selected == b.selected and a.comm_mb == pytest.approx(b.comm_mb)
        assert b.n_dropped == 0 and b.sim_time > 0.0 and a.test_loss == b.test_loss
    assert torch.equal(plain.params, inert.params)
    assert "sim_clock" not in plain.history and len(inert.history["sim_clock"]) == 3


def test_over_selection_dispatches_ceil_m_times_factor(data):
    eng = _engine(data, systems={**_ALWAYS, "deadline_s": None})
    assert eng.m_eff == 6 and eng.strategy.m == 6  # ceil(4 * 1.5)
    (r0,) = list(eng.rounds(1))
    assert len(r0.selected) == 6 and r0.n_dropped == 0


@pytest.mark.parametrize("backend", ["host", "compiled", "fused"])
def test_no_upload_round_keeps_model(backend, data):
    extra = {**BACKENDS[backend], "fuse_rounds": 2} if backend == "fused" else BACKENDS[backend]
    eng = _engine(data, systems={**_ALWAYS, "deadline_s": 1e-6}, **extra)
    before = eng.params.clone()
    rs = list(eng.rounds(2))
    assert all(r.selected == () and r.n_dropped == 6 for r in rs)
    assert all(np.isnan(r.mean_selected_loss) for r in rs)
    assert torch.equal(before, eng.params)


def test_haccs_latency_tiebreak_uses_profile(data):
    eng = _engine(data, strategy="haccs", systems=dict(profile="mobile_mix"))
    assert np.array_equal(eng.strategy.latency, eng._systems.latency_hint())
    plain = _engine(data, strategy="haccs")
    assert not np.array_equal(plain.strategy.latency, eng.strategy.latency)
    (r0,) = list(eng.rounds(1))
    assert len(r0.selected) == 4
    fedcs = _engine(data, strategy="fedcs", systems=dict(profile="mobile_mix"))
    (r0,) = list(fedcs.rounds(1))  # the four fastest devices by the profile
    assert r0.selected == tuple(sorted(np.argsort(fedcs._systems.latency_hint(),
                                                  kind="stable")[:4]))


def test_deadline_over_selection_beats_no_deadline_sim_time(data):
    kw = dict(strategy="fedlecc", strategy_kwargs={"J": 3}, rounds=10, eval_every=1)
    base_eng = _engine(data, systems=dict(profile="zipf_compute"), **kw)
    base = list(base_eng.rounds())
    d = float(np.median(base_eng._systems.clock.base_times()))
    ddl = list(_engine(data, systems=dict(profile="zipf_compute", deadline_s=d,
                                          over_select=1.5), **kw).rounds())
    target = min(max(r.test_acc for r in base), max(r.test_acc for r in ddl)) * 0.95

    def time_to(rs):
        return next(r.sim_clock for r in rs if r.test_acc >= target)

    assert any(r.n_dropped > 0 for r in ddl)
    assert time_to(ddl) < time_to(base)


def test_trace_availability_drives_the_engine(data, tmp_path):
    rows = np.ones((2, 12), int)
    rows[1, 2:] = 0
    p = tmp_path / "sched.csv"
    p.write_text("\n".join(",".join(map(str, r)) for r in rows) + "\n")
    for backend in ("host", "compiled"):
        eng = _engine(data, rounds=2, systems=dict(profile="uniform", availability="trace",
                                                   availability_kwargs={"path": str(p)}),
                      **BACKENDS[backend])
        h = list(eng.rounds())
        assert set(h[1].selected) <= {0, 1}
