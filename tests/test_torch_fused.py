"""The port's fused execution mode (``fuse_rounds > 0``) on the CPU, where
each chunk runs eagerly (on the card it is a captured CUDA graph:
``tests/test_torch_gpu.py``).

- fused chunks reproduce the eager compiled loop round for round for the
  strategies deterministic given the losses (same draws, same selections,
  parameters within 1e-6), on the classification task and the micro LM;
- under ``JaxReplayDraws`` the fused selections equal the reference
  ``FusedEngine``'s for every traced strategy, the parameters within the
  host-parity tolerance (atol 1e-5);
- ``rounds()`` in pieces equals one contiguous call; chunk boundaries are
  the reference's ``_chunk_len``;
- an empty selection gives a ``nan`` mean loss without a warning;
- ``engine.params`` is never a buffer that a later chunk overwrites."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from conftest import LM_VOCAB, fl_cfg, lm_fl_cfg  # noqa: E402
from repro.engine import make_engine as ref_make_engine  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.engine import FLConfig, make_engine, traced_selection_strategies  # noqa: E402
from test_torch_engine import JaxReplayDraws  # noqa: E402

TRACED = traced_selection_strategies()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(strategy):
    return {"strategy": strategy,
            "strategy_kwargs": {"J": 3} if strategy in ("fedlecc", "clusterrandom") else {}}


def _engine(data, draws=None, **kw):
    train, test = data
    cfg = FLConfig.from_dict(fl_cfg(**kw).to_dict())
    return make_engine(cfg, train, test, 10, device="cpu",
                       draws=None if draws is None else draws(cfg.seed, "cpu"))


@pytest.mark.parametrize("strategy", ["fedlecc", "lossonly", "haccs"])
def test_fused_matches_eager_compiled(strategy, data):
    kw = dict(_kw(strategy), rounds=6, eval_every=2, backend="compiled")
    eager, fused = _engine(data, **kw), _engine(data, fuse_rounds=3, **kw)
    assert type(fused).__name__ == "FusedEngine"
    re_, rf = list(eager.rounds(6)), list(fused.rounds(6))
    assert len(rf) == 6
    for a, b in zip(re_, rf):
        assert (a.round, a.selected, a.evaluated) == (b.round, b.selected, b.evaluated)
        assert a.comm_mb == pytest.approx(b.comm_mb)
        assert a.mean_selected_loss == pytest.approx(b.mean_selected_loss, rel=1e-5)
    assert float((eager.params - fused.params).abs().max()) < 1e-6


def test_fused_lm_matches_eager_compiled(lm_data):
    train, test = lm_data
    runs = []
    for fuse in (0, 2):
        cfg = FLConfig.from_dict(lm_fl_cfg(backend="compiled", fuse_rounds=fuse, rounds=3,
                                           eval_every=2).to_dict())
        engine = make_engine(cfg, train, test, LM_VOCAB, device="cpu")
        runs.append((list(engine.rounds()), engine))
    (ra, ea), (rb, eb) = runs
    assert [r.selected for r in ra] == [r.selected for r in rb]
    for a, b in zip(ra, rb):
        assert a.evaluated == b.evaluated
        if a.evaluated:
            assert a.metrics["ppl"] == pytest.approx(b.metrics["ppl"], rel=1e-5)
    assert float((ea.params - eb.params).abs().max()) < 1e-6


@pytest.mark.parametrize("strategy", TRACED)
def test_fused_matches_reference_fused(strategy, data):
    train, test = data
    ref_cfg = fl_cfg(backend="compiled", fuse_rounds=3, rounds=4, eval_every=3, **_kw(strategy))
    ref = ref_make_engine(ref_cfg, train, test, n_classes=10)
    ref_res = list(ref.rounds())
    eng = _engine(data, draws=JaxReplayDraws, backend="compiled", fuse_rounds=3, rounds=4,
                  eval_every=3, **_kw(strategy))
    res = list(eng.rounds())
    assert [r.selected for r in res] == [r.selected for r in ref_res]
    for r, w in zip(res, ref_res):
        assert r.comm_mb == pytest.approx(w.comm_mb)
        assert abs(r.mean_selected_loss - w.mean_selected_loss) < 1e-4
        assert r.evaluated == w.evaluated
    want = params_from_jax(jax.tree.map(np.asarray, ref.params)).numpy()
    np.testing.assert_allclose(eng.params.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("strategy", ["fedlecc", "random", "poc", "clusterrandom"])
def test_fused_chunked_vs_contiguous_rounds(strategy, data):
    kw = dict(_kw(strategy), backend="compiled", fuse_rounds=3, rounds=6, eval_every=2)
    contiguous, chunked = _engine(data, **kw), _engine(data, **kw)
    ra = list(contiguous.rounds(6))
    rb = list(chunked.rounds(2)) + list(chunked.rounds(1)) + list(chunked.rounds(3))
    assert [r.round for r in rb] == list(range(6))
    assert [r.selected for r in ra] == [r.selected for r in rb]
    assert {r.round for r in ra if r.evaluated} == {r.round for r in rb if r.evaluated}
    assert float((contiguous.params - chunked.params).abs().max()) < 1e-6
    assert ra[-1].comm_mb == pytest.approx(rb[-1].comm_mb)


def test_chunk_boundaries_follow_the_reference(data):
    train, test = data
    for fuse, every, rounds in [(2, 100, 7), (3, 2, 6), (5, 5, 16), (4, 3, 10), (1, 1, 3)]:
        kw = dict(backend="compiled", fuse_rounds=fuse, eval_every=every, rounds=rounds)
        ref = ref_make_engine(fl_cfg(**kw), train, test, n_classes=10)
        eng = _engine(data, **kw)
        for end in (rounds, rounds + 3, 2):
            for rnd in range(0, end):
                assert eng._chunk_len(rnd, end) == ref._chunk_len(rnd, end)
    eng = _engine(data, backend="compiled", fuse_rounds=2, rounds=7, eval_every=100)
    starts, rnd = [], 0
    while rnd < 7:
        starts.append(rnd)
        rnd += eng._chunk_len(rnd, 7)
    assert starts == [0, 1, 3, 5]  # chunks [0], [1, 2], [3, 4], [5, 6]


def test_empty_selection_mean_loss_is_nan_without_warning(data):
    host = _engine(data, rounds=1)
    host.select = lambda rnd, losses: np.array([], dtype=np.int64)
    host.local_train = lambda rnd, sel: (None, np.array([], np.float32))
    host.aggregate = lambda rnd, sel, payload: None
    fused = _engine(data, rounds=2, backend="compiled", fuse_rounds=2)
    fused.strategy.select_mask_traced = lambda losses, noise: torch.zeros_like(losses,
                                                                               dtype=torch.bool)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # any RuntimeWarning would raise
        results = list(host.rounds(1)) + list(fused.rounds(2))
    for result in results:
        assert np.isnan(result.mean_selected_loss) and result.selected == ()


def test_params_are_never_a_buffer_a_later_chunk_overwrites(data):
    """The reference's donation deletes a stale alias of ``engine.params``;
    the port's replays would overwrite one instead, so the engine hands out
    a copy after every chunk and an alias keeps its values."""
    engine = _engine(data, backend="compiled", fuse_rounds=2, rounds=6, eval_every=2)
    stale, before = engine.params, engine.params.clone()
    list(engine.rounds(3))
    held, held_values = engine.params, engine.params.clone()
    list(engine.rounds(3))
    assert torch.equal(stale, before) and torch.equal(held, held_values)
    assert not torch.equal(engine.params, held) and torch.isfinite(engine.params).all()
