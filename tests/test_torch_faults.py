"""The fault axis of the port (``repro_torch.faults``, ``FLConfig.faults``)
against the reference's ``repro.faults``.

- Module parity: ``FaultConfig`` validation (message for message) and its
  dict round trip, ``decide``, ``upload_fractions`` and ``ClientHealth``
  over a scripted run exactly (numpy, the reference's streams); each fault
  model's ``apply`` on the flat (m, P) cohort against the reference's on
  the same rows as a pytree, within 1e-6 — on the MLP's leaves and on a
  transformer whose leaves are stacked over layers (several stretches of
  the flat row), where ``label_flip`` and ``truncated_upload`` act leaf by
  leaf; the truncation's cut on a leaf of more than 2^24 entries (float32
  positions) exactly.  The validation gate: norms within 1e-5 relative
  (the flat row's squares sum in another order than the reference's per
  leaf), the quantile within one ulp, flagged sets exactly (no norm lies within
  1e-4 of a threshold there), clipped rows within 1e-6, and an
  all-non-finite cohort.
- Engine parity under ``JaxReplayDraws``: the port's ``HostEngine``
  against the reference's, 3 rounds: faults at 20 % with validate, a mix
  of every traced model, stale replay, and both axes together — the same
  survivors, ``n_faulty``, ``n_quarantined``, ``sim_time``, ``comm_mb``
  exactly and params within 1e-5 every round; one LM round on the xlstm
  micro config with both axes, from the reference's parameters.
- The reference's backend contracts (``tests/test_faults.py``) under the
  port's ``TorchDraws``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import LM_VOCAB, fl_cfg, lm_fl_cfg  # noqa: E402
from test_torch_systems import check_rounds_against_reference  # noqa: E402

import repro.faults as ref_faults  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.federated import aggregation as ref_aggregation  # noqa: E402
from repro.models.mlp import init_mlp  # noqa: E402
from repro.models.transformer import init_transformer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    leaf_segments,
    params_from_jax,
    transformer_params_from_jax,
)
from repro_torch.engine import FaultConfig, FLConfig, make_engine  # noqa: E402
from repro_torch.faults import ClientHealth, FaultRuntime, build_fault  # noqa: E402
from repro_torch.faults import defense  # noqa: E402
from repro_torch.faults.models import truncation_keep  # noqa: E402
from repro_torch.federated import aggregation  # noqa: E402
from repro_torch.models.mlp import MLPLayout  # noqa: E402
from repro_torch.models.transformer import TransformerLayout  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's small engine runs from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raises_same(make_ref, make_port):
    with pytest.raises((ValueError, TypeError)) as want:
        make_ref()
    with pytest.raises(want.type) as got:
        make_port()
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("kw", [
    {"rate": 1.5}, {"rate": float("nan")}, {"models": ["gremlin"]}, {"models": []},
    {"models": ["sign_flip", "sign_flip"]}, {"defense": "hope"}, {"clip_quantile": 0.0},
    {"norm_tolerance": 0.5}, {"models": ["sign_flip"], "model_kwargs": {"exploding": {}}},
    {"models": ["exploding"], "model_kwargs": {"exploding": {"nope": 1}}},
    {"models": ["exploding"], "model_kwargs": {"exploding": {"eta": 1.0}}},
    {"models": ["truncated_upload"], "model_kwargs": {"truncated_upload": {"min_frac": 0.9,
                                                                            "max_frac": 0.1}}},
    {"quarantine_rounds": -1}, {"backoff": 0.5}, {"max_backoff_exp": 1.5},
    {"fail_threshold": 0}, {"seed": 1.5},
])
def test_fault_config_rejects_what_the_reference_rejects(kw):
    _raises_same(lambda: ref_faults.FaultConfig(**kw), lambda: FaultConfig(**kw))


def test_fault_config_round_trips_and_rides_flconfig():
    _raises_same(lambda: ref_faults.FaultConfig.from_dict({"rate": 0.1, "bogus": 1}),
                 lambda: FaultConfig.from_dict({"rate": 0.1, "bogus": 1}))
    d = {"rate": 0.2, "models": "sign_flip", "defense": "validate", "quarantine_rounds": 3}
    ref, port = ref_faults.FaultConfig.from_dict(d), FaultConfig.from_dict(d)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.defended and not FaultConfig().defended
    cfg = FLConfig.from_dict(fl_cfg(faults=d).to_dict())
    assert cfg.faults == port and cfg.to_dict() == fl_cfg(faults=d).to_dict()


# ------------------------------------------------------------- decisions
_MIX = ["sign_flip", "truncated_upload", "exploding", "stale_replay"]


@pytest.mark.parametrize("seed,cfg_seed", [(9, None), (0, 4)])
def test_decide_and_upload_fractions_equal_the_reference(seed, cfg_seed):
    cfg = dict(rate=0.4, models=_MIX, seed=cfg_seed,
               model_kwargs={"truncated_upload": {"min_frac": 0.1, "max_frac": 0.6}})
    rt = FaultRuntime(FaultConfig(**cfg), n_clients=40, seed=seed,
                      params_template=torch.zeros(3))
    ref = ref_faults.FaultRuntime(ref_faults.FaultConfig(**cfg), n_clients=40, seed=seed,
                                  params_template={"w": jnp.zeros((3,))})
    for rnd in range(20):
        (k, u), (rk, ru) = rt.decide(rnd), ref.decide(rnd)
        assert k.dtype == rk.dtype and u.dtype == ru.dtype
        assert np.array_equal(k, rk) and np.array_equal(u, ru)
        assert np.array_equal(rt.upload_fractions(k, u), ref.upload_fractions(k, u))


@pytest.mark.parametrize("kw", [{}, {"quarantine_rounds": 3, "backoff": 1.5, "fail_threshold": 2},
                                {"quarantine_rounds": 0}, {"max_backoff_exp": 1}])
def test_client_health_equals_the_reference_over_a_scripted_run(kw):
    h, ref = ClientHealth(20, **kw), ref_faults.ClientHealth(20, **kw)
    rng = np.random.default_rng(7)
    for t in range(40):
        arrivals = np.sort(rng.choice(20, size=8, replace=False))
        flagged = arrivals[rng.random(8) < 0.4]
        h.record(t, arrivals, flagged)
        ref.record(t, arrivals, flagged)
        assert h.state_dict() == ref.state_dict()
        assert np.array_equal(h.admitted(t + 1), ref.admitted(t + 1))
        assert h.n_quarantined(t) == ref.n_quarantined(t)
    fresh = ClientHealth(20, **kw)
    fresh.load_state_dict(ref.state_dict())
    assert fresh.state_dict() == ref.state_dict()


# ------------------------------------------------------------- the models
def _mlp_cohort(m, seed=0):
    """(m, P) rows and (P,) fetched params of a (12, 7, 5) MLP, as the
    reference's pytrees and as the port's flat tensors, with its leaves."""
    fetched = init_mlp(jax.random.PRNGKey(seed), (12, 7, 5))
    rng = np.random.default_rng(seed)
    stacked = jax.tree.map(
        lambda a: np.asarray(a)[None] + rng.normal(0, 0.1, (m,) + a.shape).astype(np.float32),
        fetched)
    rows = torch.stack([params_from_jax(jax.tree.map(lambda a, i=i: a[i], stacked))
                        for i in range(m)])
    flat = params_from_jax(jax.tree.map(np.asarray, fetched))
    return (stacked, fetched, params_from_jax), (rows, flat,
                                                 leaf_segments(MLPLayout((12, 7, 5))))


def _transformer_cohort(m, seed=0):
    """The same for a 2-layer stablelm micro model: its leaves under
    ``layers`` are stacked over the layers, two stretches of the flat row."""
    over = {"d_model": 32, "n_heads": 2, "n_kv_heads": 2, "head_dim": 16, "d_ff": 64,
            "vocab": 32, "n_layers": 2}
    ref_cfg = dataclasses.replace(ref_get_config("stablelm-3b", reduced=True), **over)
    cfg = dataclasses.replace(get_config("stablelm-3b", reduced=True), **over)
    fetched = init_transformer(jax.random.PRNGKey(seed), ref_cfg)
    rng = np.random.default_rng(seed)
    stacked = jax.tree.map(
        lambda a: np.asarray(a)[None] + rng.normal(0, 0.1, (m,) + a.shape).astype(np.float32),
        fetched)
    conv = lambda tree: transformer_params_from_jax(tree, cfg)  # noqa: E731
    rows = torch.stack([conv(jax.tree.map(lambda a, i=i: a[i], stacked)) for i in range(m)])
    return (stacked, fetched, conv), (rows, conv(jax.tree.map(np.asarray, fetched)),
                                      leaf_segments(TransformerLayout(cfg)))


@pytest.mark.parametrize("layout", ["mlp", "transformer"])
@pytest.mark.parametrize("name,kw", [
    ("nan_update", {}), ("exploding", {"eta": 10.0}), ("exploding", {}), ("sign_flip", {}),
    ("label_flip", {}), ("stale_replay", {}), ("truncated_upload", {}),
    ("truncated_upload", {"min_frac": 0.0, "max_frac": 1.0}),
])
def test_fault_models_equal_the_reference_leaf_by_leaf(layout, name, kw):
    m = 5
    (stacked, fetched, conv), (rows, flat, leaves) = (
        _mlp_cohort(m) if layout == "mlp" else _transformer_cohort(m))
    if layout == "transformer":
        assert any(len(segs) > 1 for segs in leaves)  # leaves of several stretches
    ref, port = ref_faults.build_fault(name, **kw), build_fault(name, **kw)
    u = port.draw_param(np.random.default_rng(1), m).astype(np.float32)
    assert np.array_equal(u, ref.draw_param(np.random.default_rng(1), m).astype(np.float32))
    want = ref.apply(jax.tree.map(jnp.asarray, stacked), fetched, jnp.asarray(u))
    want = torch.stack([conv(jax.tree.map(lambda a, i=i: np.asarray(a[i]), want))
                        for i in range(m)])
    got = port.apply(rows, flat, torch.as_tensor(u), leaves)
    assert got.shape == rows.shape and got.dtype == rows.dtype
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6, equal_nan=True)
    if name in ("label_flip", "truncated_upload"):  # the whole row as one leaf differs
        whole = port.apply(rows, flat, torch.as_tensor(u), None)
        assert not torch.allclose(whole, want, atol=1e-6)


def test_truncation_cut_above_2_to_the_24_is_the_reference_float32_cut():
    """One leaf of 2^24 + 64 entries: float32 positions there are 2 apart,
    so the reference's float32 compare keeps another prefix than an integer
    compare would; the port keeps the reference's (int8 rows keep it cheap)."""
    n = 2**24 + 64
    u = np.array([(2**24 + 4) / n, (2**24 + 3.5) / n, (2**24 + 7) / n, 0.5], np.float32)
    cut = u * np.float32(n)
    assert (cut > 2**24).sum() == 3
    ref = ref_faults.build_fault("truncated_upload", min_frac=0.0, max_frac=1.0)
    want = np.asarray(ref.apply({"w": jnp.ones((4, n), jnp.int8)}, {"w": jnp.zeros(n, jnp.int8)},
                                jnp.asarray(u))["w"]).astype(bool)
    got = truncation_keep(torch.as_tensor(u), n).numpy()
    assert np.array_equal(got.sum(1), want.sum(1)) and np.array_equal(got, want)
    integer_cut = np.ceil(cut.astype(np.float64)).astype(np.int64)
    assert not np.array_equal(got.sum(1), integer_cut)  # where an integer compare would cut


# -------------------------------------------------------- the validation gate
def _gate_inputs(seed, m=9):
    (stacked, fetched, _), (rows, flat, _) = _mlp_cohort(m, seed)
    scale = np.ones(m, np.float32)
    scale[1], scale[4], scale[6] = 40.0, 2.5, 0.3
    stacked = jax.tree.map(lambda s, f: np.asarray(f)[None] + (s - np.asarray(f)[None])
                           * scale.reshape((-1,) + (1,) * (s.ndim - 1)), stacked, fetched)
    rows = flat[None] + (rows - flat[None]) * torch.as_tensor(scale)[:, None]
    stacked[0]["w"][3, 0, 0] = np.nan
    rows[3, 0] = float("nan")
    stacked[1]["b"][7, 0] = np.inf
    rows[7, rows.shape[1] - 5] = float("inf")
    valid = np.random.default_rng(seed).random(m) < 0.8
    valid[[1, 3]] = True
    return (stacked, fetched), (rows, flat), valid


@pytest.mark.parametrize("q,tol", [(0.9, 3.0), (0.5, 3.0), (0.5, 1.5), (1.0, 3.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_validation_gate_matches_the_reference(seed, q, tol):
    (stacked, fetched), (rows, flat), valid = _gate_inputs(seed)
    want_out, want_flag, want_norm = ref_faults.validate_updates(
        jax.tree.map(jnp.asarray, stacked), fetched, jnp.asarray(valid), q=q, tol=tol)
    got_out, got_flag, got_norm = defense.validate_updates(rows, flat, torch.as_tensor(valid),
                                                           q=q, tol=tol)
    want_norm = np.asarray(want_norm)
    np.testing.assert_allclose(got_norm.numpy(), want_norm, rtol=1e-5)
    finite = np.isfinite(want_norm)
    thr = np.quantile(want_norm[valid & finite], q)
    ok = valid & finite
    # the inputs keep every norm clear of the flagging threshold
    assert (np.abs(want_norm[ok] - tol * thr) > 1e-4 * tol * thr).all()
    assert np.array_equal(got_flag.numpy(), np.asarray(want_flag))
    assert got_flag.numpy()[3] and (q > 0.5 or got_flag.numpy()[1])
    want_rows = torch.stack([params_from_jax(jax.tree.map(lambda a, i=i: np.asarray(a[i]),
                                                          want_out)) for i in range(len(valid))])
    torch.testing.assert_close(got_out, want_rows, rtol=1e-6, atol=1e-6)
    assert torch.isfinite(got_out).all()
    assert torch.equal(got_out[3], flat)  # the NaN row neutralized to the fetched params
    untouched = torch.as_tensor(((want_norm < thr * (1 - 1e-6)) | ~valid) & finite)
    assert torch.equal(got_out[untouched], rows[untouched])  # bit for bit


def test_nanquantile_matches_jax_within_one_ulp():
    """The same ranks, weights and gathers as ``jnp.nanquantile``; XLA on a
    CPU fuses the final ``low·(1−w) + high·w`` into a multiply-add, so the
    last bit may differ."""
    rng = np.random.default_rng(0)
    for n in (1, 2, 5, 9, 13, 16):
        for q in (0.0, 0.3, 0.5, 0.9, 1.0):
            x = rng.lognormal(0, 1, n).astype(np.float32)
            x[rng.random(n) < 0.3] = np.nan
            want = np.asarray(jnp.nanquantile(jnp.asarray(x), q))
            got = defense.nanquantile(torch.as_tensor(x), q).numpy()
            assert np.isnan(got) == np.isnan(want), (n, q)
            if not np.isnan(want):
                assert abs(got - want) <= np.spacing(want), (n, q)


def test_all_nonfinite_cohort_flags_everyone():
    rows = torch.full((3, 2), float("nan"))
    flat = torch.zeros(2)
    out, flagged, norm = defense.validate_updates(rows, flat, torch.ones(3, dtype=torch.bool),
                                                  q=0.9, tol=3.0)
    _, want, _ = ref_faults.validate_updates({"w": jnp.full((3, 2), jnp.nan)},
                                             {"w": jnp.zeros((2,))}, jnp.ones(3, bool),
                                             q=0.9, tol=3.0)
    assert flagged.all() and np.asarray(want).all()
    assert torch.equal(out, torch.zeros(3, 2)) and torch.isinf(norm).all()


# ------------------------------------- engine parity under the reference's draws
_FAULTS = {"rate": 0.2, "models": ["sign_flip", "nan_update"], "defense": "validate"}
_SYS = dict(profile="zipf_compute", availability="bernoulli", availability_kwargs={"p": 0.7},
            deadline_s=2.0, over_select=1.5, jitter_sigma=0.1)
ENGINE_CASES = {
    "faults_20pct_validate": {"faults": _FAULTS},
    "every_traced_model": {"faults": {"rate": 0.5, "defense": "validate",
                                      "models": ["label_flip", "truncated_upload",
                                                 "exploding", "sign_flip"]}},
    "stale_replay": {"strategy": "random", "n_clients": 6, "m": 6, "rounds": 4,
                     "faults": {"rate": 0.5, "models": ["stale_replay"]}},
    "both_axes": {"systems": _SYS, "faults": {**_FAULTS, "rate": 0.3}},
}


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_host_rounds_match_the_reference_under_faults(data, name):
    rs = check_rounds_against_reference(data, fl_cfg(**ENGINE_CASES[name]))
    assert sum(r.n_faulty for r in rs) > 0


def test_xlstm_micro_lm_round_with_both_axes_matches_the_reference(lm_data):
    micro = {"model": "xlstm-125m", "hist_bins": 16,
             "overrides": {"n_layers": 4, "d_model": 32, "vocab": LM_VOCAB, "loss_chunk": 16}}
    cfg = lm_fl_cfg(task_kwargs=micro, max_steps_cap=1, rounds=1, systems=_SYS,
                    faults={**_FAULTS, "rate": 0.5})
    (r,) = check_rounds_against_reference(lm_data, cfg, LM_VOCAB, resync=True)
    assert r.n_faulty > 0 and r.sim_time > 0 and len(r.selected) < 5  # m_eff = 5


# ---------------------------------------- the reference's contracts, TorchDraws
def _engine(data, task="classification", **kw):
    train, test = data
    cfg = (lm_fl_cfg if task == "lm" else fl_cfg)(**kw)
    return make_engine(FLConfig.from_dict(cfg.to_dict()), train, test,
                       LM_VOCAB if task == "lm" else 10, device="cpu")


_CELLS = [("classification", "host"), ("classification", "compiled"),
          ("classification", "fused"), ("lm", "host"), ("lm", "compiled")]


@pytest.mark.parametrize("task,backend", _CELLS, ids=[f"{t}-{b}" for t, b in _CELLS])
def test_rate_zero_is_bit_identical(task, backend, data, lm_data):
    extra = ({"backend": "compiled", "fuse_rounds": 2, "rounds": 4, "eval_every": 2}
             if backend == "fused" else {"backend": backend})
    runs = {}
    for name, faults in (("off", None), ("rate0", {"rate": 0.0}),
                         ("defended0", {"rate": 0.0, "defense": "validate",
                                        "clip_quantile": 1.0})):
        eng = _engine(lm_data if task == "lm" else data, task, faults=faults, **extra)
        runs[name] = (eng.params, list(eng.rounds()))
    p0, h0 = runs["off"]
    for name in ("rate0", "defended0"):
        p, h = runs[name]
        assert torch.equal(p0, p), name
        for a, b in zip(h0, h, strict=True):
            assert (a.selected, a.comm_mb, a.test_loss) == (b.selected, b.comm_mb, b.test_loss)
            assert (b.n_faulty, b.n_quarantined) == (0, 0)


@pytest.mark.parametrize("faults", [_FAULTS, {"rate": 0.5, "models": ["stale_replay",
                                                                     "sign_flip"]}],
                         ids=["sign_flip+nan_update", "stale_replay"])
def test_host_compiled_lockstep_under_faults(data, faults):
    runs = {}
    for backend in ("host", "compiled"):
        eng = _engine(data, backend=backend, rounds=4, faults=faults)
        runs[backend] = (eng, list(eng.rounds()))
    (eh, hh), (ec, hc) = runs["host"], runs["compiled"]
    for a, b in zip(hh, hc, strict=True):
        assert a.selected == b.selected and a.comm_mb == b.comm_mb
        assert (a.n_faulty, a.n_quarantined) == (b.n_faulty, b.n_quarantined)
    assert float((eh.params - ec.params).abs().max()) < 5e-5
    assert torch.isfinite(eh.params).all() and sum(r.n_faulty for r in hh) > 0


def test_fused_rate_zero_and_lockstep_with_eager(data):
    kw = dict(backend="compiled", rounds=4, eval_every=1)
    faults = {"rate": 0.3, "models": ["sign_flip", "nan_update"], "defense": "validate"}
    eager = _engine(data, faults=faults, **kw)
    fused = _engine(data, fuse_rounds=4, faults=faults, **kw)  # chunks of 1: no lag
    he, hf = list(eager.rounds()), list(fused.rounds())
    for a, b in zip(he, hf, strict=True):
        assert a.selected == b.selected
        assert (a.n_faulty, a.n_quarantined) == (b.n_faulty, b.n_quarantined)
    assert torch.equal(eager.params, fused.params) and torch.isfinite(fused.params).all()


def test_fused_long_chunks_contain_nans(data):
    eng = _engine(data, backend="compiled", fuse_rounds=3, rounds=6, eval_every=3,
                  faults={"rate": 1.0, "models": ["nan_update"], "defense": "validate"})
    hist = list(eng.rounds())
    assert torch.isfinite(eng.params).all() and all(r.selected == () for r in hist)
    assert eng.history["n_faulty"] and "sim_clock" not in eng.history


@pytest.mark.parametrize("backend", ["host", "compiled", "fused"])
def test_all_quarantined_round_leaves_params_unchanged(data, backend):
    extra = ({"backend": "compiled", "fuse_rounds": 2} if backend == "fused"
             else {"backend": backend})
    eng = _engine(data, rounds=2, n_clients=8, m=3, faults={
        "rate": 1.0, "models": ["nan_update"], "defense": "validate"}, **extra)
    before = eng.params.clone()
    hist = list(eng.rounds())
    assert torch.equal(before, eng.params)
    assert all(r.selected == () for r in hist) and hist[-1].n_quarantined > 0


def test_truncated_upload_reduces_comm(data):
    full = _engine(data, rounds=3, faults={"rate": 0.0})
    part = _engine(data, rounds=3, faults={"rate": 0.9, "models": ["truncated_upload"]})
    assert list(part.rounds())[-1].comm_mb < list(full.rounds())[-1].comm_mb


def test_stale_replay_resends_last_honest_params(data):
    eng = _engine(data, rounds=4, n_clients=6, m=6, strategy="random",
                  faults={"rate": 0.5, "models": ["stale_replay"]})
    hist = list(eng.rounds())
    assert sum(r.n_faulty for r in hist) > 0 and torch.isfinite(eng.params).all()
    sent = eng._faults.stale_state()["sent"]
    assert eng._faults.has_stale and sent.shape == (6,) and sent.sum() >= 1


def test_robust_aggregators_ignore_zero_weight_rows():
    x = torch.tensor([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0], [1e9, -1e9], [float("nan")] * 2])
    w = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0])
    for fn, args in ((aggregation.trimmed_mean, (0.0,)), (aggregation.coordinate_median, ())):
        got = fn(x, w, *args)
        want = getattr(ref_aggregation, fn.__name__)({"w": jnp.asarray(x.numpy())},
                                                      jnp.asarray(w.numpy()), *args)["w"]
        np.testing.assert_allclose(got.numpy(), [2.0, 2.0], rtol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("aggregator,kwargs", [("trimmed_mean", {"trim_frac": 0.25}),
                                               ("coordinate_median", {})])
@pytest.mark.parametrize("backend", ["host", "compiled"])
def test_robust_aggregators_defend_the_model(data, aggregator, kwargs, backend):
    eng = _engine(data, backend=backend, rounds=3, aggregator=aggregator,
                  aggregator_kwargs=kwargs,
                  faults={"rate": 0.25, "models": ["exploding"], "defense": "validate"})
    list(eng.rounds())
    assert torch.isfinite(eng.params).all()
