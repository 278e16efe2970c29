"""The port's compiled backend against the reference's on the CPU.

Under ``JaxReplayDraws`` (``tests/test_torch_engine.py``) the port's
``backend="compiled"`` run must select exactly the reference compiled
backend's clients every round and end within the host-parity tolerance
(atol 1e-5) of its parameters, for every mask strategy, on the
classification task (3 rounds) and the micro LM (``lm_fl_cfg``, 2
rounds), and for every aggregator; it must also equal the port's own host
run.  The legacy ``cohort_gather=False`` path must equal the gathered
one.  Config errors must read as the reference's, message for message,
and ``backend="scaleout"`` (``tests/test_torch_scaleout.py``) builds as the
reference's does."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from conftest import LM_VOCAB, fl_cfg, lm_fl_cfg  # noqa: E402
from repro.engine import FLConfig as RefFLConfig  # noqa: E402
from repro.engine import make_engine as ref_make_engine  # noqa: E402
from repro_torch.convert import params_from_jax, transformer_params_from_jax  # noqa: E402
from repro_torch.engine import FLConfig, make_engine, mask_selection_strategies  # noqa: E402
from test_torch_engine import JaxReplayDraws  # noqa: E402

MASK = mask_selection_strategies()
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(cfg, data, n_classes, **kw):
    train, test = data
    return make_engine(cfg, train, test, n_classes, device="cpu",
                       draws=JaxReplayDraws(cfg.seed, "cpu"), **kw)


def _flat(engine, ref_params):
    tree = jax.tree.map(np.asarray, ref_params)
    if engine.cfg.task == "lm":
        return transformer_params_from_jax(tree, engine.task.model_cfg).numpy()
    return params_from_jax(tree).numpy()


def _check(ref_eng, ref_res, eng, res):
    assert [r.selected for r in res] == [r.selected for r in ref_res]
    for r, w in zip(res, ref_res):
        assert r.comm_mb == pytest.approx(w.comm_mb)
        assert abs(r.mean_selected_loss - w.mean_selected_loss) < 1e-4
        assert r.evaluated == w.evaluated
    np.testing.assert_allclose(eng.params.numpy(), _flat(eng, ref_eng.params), atol=ATOL)


def _run_grid(ref_cfg, data, n_classes, rounds):
    train, test = data
    ref_eng = ref_make_engine(ref_cfg, train, test, n_classes=n_classes)
    ref_res = list(ref_eng.rounds(rounds))
    cfg = FLConfig.from_dict(ref_cfg.to_dict())
    eng = _port(cfg, data, n_classes)
    assert type(eng).__name__ == "CompiledEngine" and eng.cohort_gather
    _check(ref_eng, ref_res, eng, list(eng.rounds(rounds)))
    host = _port(FLConfig.from_dict({**cfg.to_dict(), "backend": "host"}), data, n_classes)
    host_res = list(host.rounds(rounds))
    assert [r.selected for r in host_res] == [r.selected for r in ref_res]
    np.testing.assert_allclose(host.params.numpy(), eng.params.numpy(), atol=ATOL)


@pytest.mark.parametrize("strategy", MASK)
def test_compiled_matches_reference_classification(strategy, data):
    kw = {"strategy_kwargs": {"J": 3}} if strategy in ("fedlecc", "clusterrandom") else {}
    _run_grid(fl_cfg(backend="compiled", strategy=strategy, **kw), data, 10, 3)


@pytest.mark.parametrize("strategy", MASK)
def test_compiled_matches_reference_lm(strategy, lm_data):
    kw = {"strategy_kwargs": {"J": 2}} if strategy in ("fedlecc", "clusterrandom") else {}
    _run_grid(lm_fl_cfg(backend="compiled", strategy=strategy, **kw), lm_data, LM_VOCAB, 2)


@pytest.mark.parametrize("aggregator", ["fednova", "feddyn", "trimmed_mean", "coordinate_median"])
def test_compiled_aggregators_match_reference(aggregator, data):
    kw = {"mu": 0.1} if aggregator == "feddyn" else {}
    _run_grid(fl_cfg(backend="compiled", strategy="random", aggregator=aggregator, **kw),
              data, 10, 3)


@pytest.mark.parametrize("aggregator", ["fedavg", "fednova", "trimmed_mean"])
def test_cohort_gather_off_matches_gathered(aggregator, data):
    cfg = FLConfig.from_dict(fl_cfg(backend="compiled", aggregator=aggregator).to_dict())
    gathered, legacy = _port(cfg, data, 10), _port(cfg, data, 10, cohort_gather=False)
    assert gathered.cohort_gather and not legacy.cohort_gather
    ra, rb = list(gathered.rounds()), list(legacy.rounds())
    assert [r.selected for r in ra] == [r.selected for r in rb]
    for a, b in zip(ra, rb):
        assert a.mean_selected_loss == pytest.approx(b.mean_selected_loss, rel=1e-5)
    np.testing.assert_allclose(gathered.params.numpy(), legacy.params.numpy(), atol=1e-6)


BAD_CONFIGS = [
    dict(backend="compiled", strategy="fedcls"),
    dict(backend="compiled", strategy="fedcor"),
    dict(backend="compiled", client_mode="fedprox"),
    dict(backend="compiled", fuse_rounds=-1),
    dict(backend="host", fuse_rounds=2),
    dict(backend="compiled", strategy="fedlecc_adaptive", fuse_rounds=2),
    dict(backend="compiled", fuse_rounds=2, aggregator="fednova"),
    dict(backend="compiled", compress_bits=9),
    dict(backend="compiled", compress_bits=1),
    dict(backend="host", compress_bits=8),
    dict(backend="compiled", compress_bits=8, aggregator="trimmed_mean"),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_config_errors_match_reference(kw):
    with pytest.raises(ValueError) as ref_err:
        RefFLConfig(**kw)
    with pytest.raises(ValueError) as err:
        FLConfig(**kw)
    assert str(err.value) == str(ref_err.value)


def test_valid_compiled_configs_round_trip():
    for kw in (dict(backend="compiled"), dict(backend="compiled", fuse_rounds=3, compress_bits=8),
               dict(backend="compiled", strategy="fedlecc_adaptive", aggregator="feddyn")):
        cfg = FLConfig(**kw)
        assert FLConfig.from_dict(cfg.to_dict()) == cfg
        assert cfg.to_dict() == RefFLConfig(**kw).to_dict()


def test_scaleout_stays_unported():
    # ported in the scaleout slice: the config builds as the reference's does
    cfg = FLConfig(backend="scaleout")
    assert cfg.to_dict() == RefFLConfig(backend="scaleout").to_dict()
    assert FLConfig.from_dict(cfg.to_dict()) == cfg


def test_engine_checks_the_mask_backend_again(data):
    """A config mutated after validation fails at engine build with the
    same message."""
    cfg = FLConfig.from_dict(fl_cfg(backend="compiled").to_dict())
    cfg.strategy, cfg.strategy_kwargs = "fedcls", {}
    with pytest.raises(ValueError) as err:
        _port(cfg, data, 10)
    with pytest.raises(ValueError) as ref_err:
        RefFLConfig(**{**fl_cfg().to_dict(), "backend": "compiled", "strategy": "fedcls",
                       "strategy_kwargs": {}})
    assert str(err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="cohort_gather=False applies to backend='compiled'"):
        _port(FLConfig.from_dict(fl_cfg().to_dict()), data, 10, cohort_gather=False)
