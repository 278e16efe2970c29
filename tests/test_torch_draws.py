"""The port's default draws (``TorchDraws``): every row index and every
selection-noise value comes from a counter-based hash of (seed, round,
stream, client, position) in int64 torch ops.

- the hash's bits equal a numpy ``uint64`` implementation of the same
  function (the oracle below), and the derived rows, uniforms and
  permutations equal the oracle's;
- a client's rows do not depend on the cohort or on earlier draws:
  ``batch_indices`` gives exactly the cohort's rows of
  ``client_batch_indices``, and a poll gives the same rows whatever was
  drawn before it; the rows are valid and spread evenly;
- the reference's cross-backend contract
  (``tests/test_backend_conformance.py``, ``tests/test_fused.py``) under
  these draws: host and compiled select the same clients every round,
  bill the same MB and end within 1e-5, for every mask strategy on the
  tiny classification config and on ``lm_fl_cfg()``; compiled and fused
  agree for fedlecc, lossonly and haccs; fused equals host end to end."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import LM_VOCAB, fl_cfg, lm_fl_cfg  # noqa: E402
from repro_torch.engine import FLConfig, make_engine, mask_selection_strategies  # noqa: E402
from repro_torch.engine.draws import BATCH, NOISE, POLL, TorchDraws, counter_hash  # noqa: E402

U64 = np.uint64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small engine runs from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mix_np(x):
    x = x ^ (x >> U64(30))
    x = x * U64(0xBF58476D1CE4E5B9)
    x = x ^ (x >> U64(27))
    x = x * U64(0x94D049BB133111EB)
    return x ^ (x >> U64(31))


def _fold_np(h, v):
    return _mix_np(h + (np.asarray(v, np.uint64) + U64(1)) * U64(0x9E3779B97F4A7C15))


def oracle_hash(seed, rnd, stream, client, pos):
    """numpy uint64: fold the seed, the stream and the round into a key,
    then the client, then the position (splitmix64's mix after each)."""
    with np.errstate(over="ignore"):
        key = np.zeros(1, np.uint64)
        for v in (seed, stream, rnd):
            key = _fold_np(key, v)
        return _fold_np(_fold_np(key, np.asarray(client, np.uint64)), np.asarray(pos, np.uint64))


def _bits(t):
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("seed,rnd,stream", [(0, 0, POLL), (3, 17, BATCH), (2**31 - 1, 149, NOISE)])
def test_hash_bits_equal_the_numpy_oracle(seed, rnd, stream):
    client = np.arange(100)[:, None]
    pos = np.arange(64)[None, :]
    got = counter_hash(seed, rnd, stream, torch.as_tensor(client), torch.as_tensor(pos))
    assert got.dtype == torch.int64 and got.shape == (100, 64)
    np.testing.assert_array_equal(_bits(got), oracle_hash(seed, rnd, stream, client, pos))


def _probs(counts, width):
    mask = (np.arange(width)[None, :] < np.asarray(counts)[:, None]).astype(np.float32)
    m = torch.from_numpy(mask)
    return m / torch.clamp(m.sum(-1, keepdim=True), min=1e-9)


def test_rows_uniforms_and_permutations_equal_the_oracle():
    seed, rnd, counts = 5, 7, [13, 1, 40, 0, 27]
    probs = _probs(counts, 40)
    draws = TorchDraws(seed, "cpu")
    h = oracle_hash(seed, rnd, POLL, np.arange(5)[:, None], np.arange(9)[None, :])
    want = ((h >> U64(32)) * np.asarray(counts, np.uint64)[:, None]) >> U64(32)
    np.testing.assert_array_equal(draws.poll_indices(rnd, probs, 9).numpy(), want.astype(np.int64))

    (u,) = draws.selection_noise(rnd, "uniform", 12, 3)
    bits = oracle_hash(seed, rnd, NOISE, 0, np.arange(12)) >> U64(40)
    want_u = bits.astype(np.float32) * 2.0**-24
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(), want_u)
    (g,) = draws.selection_noise(rnd, "gumbel", 12, 3)
    uc = np.maximum(want_u, np.finfo(np.float32).tiny).astype(np.float64)
    np.testing.assert_array_equal(g.numpy(), (-np.log(-np.log(uc))).astype(np.float32))
    perm_c, perm_k = draws.selection_noise(rnd, "permutations", 12, 3)
    for perm, sub, n in ((perm_c, 1, 3), (perm_k, 2, 12)):
        keys = oracle_hash(seed, rnd, NOISE, sub, np.arange(n)).view(np.int64)
        np.testing.assert_array_equal(perm.numpy(), np.argsort(keys, kind="stable"))
        assert sorted(perm.tolist()) == list(range(n))


def test_rows_depend_on_neither_the_cohort_nor_earlier_draws():
    counts = [30, 5, 17, 30, 1, 22]
    probs = _probs(counts, 30)
    a, b = TorchDraws(0, "cpu"), TorchDraws(0, "cpu")
    b.bind_rows(probs)
    every = a.client_batch_indices(4, probs, 3, 8)
    assert every.shape == (3, 6, 8)
    cohort = np.array([5, 0, 3])
    for draws in (a, b):  # the table built from the cohort's rows or bound once
        got = draws.batch_indices(4, cohort, probs[torch.as_tensor(cohort)], 3, 8)
        assert torch.equal(got, every[:, cohort])
    first = a.poll_indices(9, probs, 16)
    b.selection_noise(9, "gumbel", 6, 2)
    b.client_batch_indices(9, probs, 2, 4)
    assert torch.equal(b.poll_indices(9, probs, 16), first)
    assert not torch.equal(a.poll_indices(10, probs, 16), first)
    for k, n in enumerate(counts):
        assert 0 <= int(every[:, k].min()) and int(every[:, k].max()) < n


def test_rows_are_spread_evenly():
    """200,000 rows of a 7-row client: each row's share within 1 % of 1/7
    (about 5 standard deviations of a uniform draw's share)."""
    draws = TorchDraws(1, "cpu")
    rows = draws.poll_indices(0, _probs([7], 7), 200_000)
    share = np.bincount(rows.numpy().ravel(), minlength=7) / 200_000
    np.testing.assert_allclose(share, 1 / 7, atol=0.01)


# ------------------------------------------------- the conformance grid

N_CLASSES = {"classification": 10, "lm": LM_VOCAB}
ROUNDS = {"classification": 3, "lm": 2}


def _engine(task, data, **kw):
    train, test = data
    cfg = (lm_fl_cfg if task == "lm" else fl_cfg)(**kw)
    return make_engine(FLConfig.from_dict(cfg.to_dict()), train, test, N_CLASSES[task],
                       device="cpu")


def _check_same(ra, ea, rb, eb, atol):
    assert [r.selected for r in ra] == [r.selected for r in rb]
    for a, b in zip(ra, rb):
        assert a.round == b.round
        assert a.comm_mb == pytest.approx(b.comm_mb)
        assert a.mean_selected_loss == pytest.approx(b.mean_selected_loss, rel=1e-4)
    assert float((ea.params - eb.params).abs().max()) <= atol


@pytest.mark.parametrize("strategy", mask_selection_strategies())
@pytest.mark.parametrize("task", ["classification", "lm"])
def test_host_equals_compiled_under_torch_draws(task, strategy, data, lm_data):
    datasets = lm_data if task == "lm" else data
    runs = []
    for backend in ("host", "compiled"):
        engine = _engine(task, datasets, strategy=strategy, backend=backend)
        runs.append((list(engine.rounds(ROUNDS[task])), engine))
    (ra, ea), (rb, eb) = runs
    assert len(ra) == ROUNDS[task]
    _check_same(ra, ea, rb, eb, 1e-5)


@pytest.mark.parametrize("strategy", ["fedlecc", "lossonly", "haccs"])
@pytest.mark.parametrize("task", ["classification", "lm"])
def test_compiled_equals_fused_under_torch_draws(task, strategy, data, lm_data):
    kw = dict(strategy=strategy, rounds=6, eval_every=2, backend="compiled")
    if strategy == "fedlecc":
        kw["strategy_kwargs"] = {"J": 3 if task == "classification" else 2}
    datasets = lm_data if task == "lm" else data
    eager, fused = _engine(task, datasets, **kw), _engine(task, datasets, fuse_rounds=3, **kw)
    _check_same(list(eager.rounds(6)), eager, list(fused.rounds(6)), fused, 1e-6)


@pytest.mark.parametrize("task", ["classification", "lm"])
def test_fused_equals_host_end_to_end_under_torch_draws(task, data, lm_data):
    datasets = lm_data if task == "lm" else data
    host = _engine(task, datasets, backend="host", rounds=4)
    fused = _engine(task, datasets, backend="compiled", fuse_rounds=4, rounds=4)
    _check_same(list(host.rounds(4)), host, list(fused.rounds(4)), fused, 1e-5)
