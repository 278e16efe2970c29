"""Port parity for the named method presets and the batching pipeline:
``repro_torch.engine.presets`` registers the reference's presets with the
same values, each classification preset's config round-trips into the
reference's ``FLConfig`` unchanged, ``fedlecc_lm`` (on xlstm-125m, the
LM task's default model) builds the reference's config, and
``batch_iterator`` yields the reference's batches for a seed."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.data.pipeline import batch_iterator as ref_batch_iterator  # noqa: E402
from repro.engine import FLConfig as RefFLConfig  # noqa: E402
from repro.engine.presets import get_preset as ref_get_preset  # noqa: E402
from repro.engine.presets import list_presets as ref_list_presets  # noqa: E402
from repro_torch.data import batch_iterator  # noqa: E402
from repro_torch.engine import FLConfig, get_preset, list_presets  # noqa: E402

CLASSIFICATION = [n for n in ref_list_presets() if ref_get_preset(n).task == "classification"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_presets_are_the_references():
    assert list_presets() == ref_list_presets()
    assert list_presets(fast_only=True) == ref_list_presets(fast_only=True)
    assert len(CLASSIFICATION) == 10
    names = [f.name for f in dataclasses.fields(ref_get_preset("fedavg"))]
    assert [f.name for f in dataclasses.fields(get_preset("fedavg"))] == names
    for preset in list_presets():
        got, want = get_preset(preset), ref_get_preset(preset)
        assert [getattr(got, n) for n in names] == [getattr(want, n) for n in names]


@pytest.mark.parametrize("name", CLASSIFICATION)
def test_preset_config_round_trips_into_the_reference(name):
    over = dict(n_clients=12, m=4, rounds=3, seed=2)
    cfg = get_preset(name).make_config(**over)
    want = ref_get_preset(name).make_config(**over).to_dict()
    assert cfg.to_dict() == want
    assert RefFLConfig.from_dict(cfg.to_dict()).to_dict() == want
    assert FLConfig.from_dict(want) == cfg


def test_lm_preset_raises_naming_its_slice():
    """Ported with xlstm-125m: the preset no longer raises; it builds the
    reference's config (``tests/test_torch_xlstm.py`` runs a round)."""
    cfg = get_preset("fedlecc_lm").make_config()
    assert cfg.to_dict() == ref_get_preset("fedlecc_lm").make_config().to_dict()


@pytest.mark.parametrize("n,batch,drop,epochs,seed", [(50, 8, True, 2, 0), (50, 8, False, 3, 1),
                                                      (64, 16, True, 1, 7)])
def test_batch_iterator_matches_reference(n, batch, drop, epochs, seed):
    rng = np.random.default_rng(seed)
    x, y = rng.standard_normal((n, 3)).astype(np.float32), rng.integers(0, 5, n)
    got = list(batch_iterator(x, y, batch, seed=seed, drop_remainder=drop, epochs=epochs))
    want = list(ref_batch_iterator(x, y, batch, seed=seed, drop_remainder=drop, epochs=epochs))
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_batch_iterator_without_epochs_runs_on():
    x = np.arange(10)
    it = batch_iterator(x, x, 4, seed=3)
    assert sum(1 for _ in zip(range(7), it)) == 7  # 2 batches an epoch, past the third epoch
