"""Acceptance of the port's main path against the reference's learning
curve: ``examples/quickstart.py``'s own config (40 clients, m = 6, 30
rounds, FedLECC J = 4, shards at target HD 0.85, 10,000 / 2,000 samples,
evaluation every 5 rounds) under the port's own randomness
(``TorchDraws``).  The port alone runs here, against constants.

The gate is the mean test accuracy of the last three evaluated rounds
(20, 25, 29), averaged over seeds 0, 1 and 2: the curve swings by up to
0.12 between evaluations, so a final-round gate would be noise.  The
constants are the reference's: its ``HostEngine`` on this config for
seeds 0–24 (``scripts/quickstart_band.py --seeds 25``, run once on a CPU
under jax 0.9.0) gave a last-three mean of 0.4272 with a standard
deviation of 0.0847 across seeds (seed 0: 0.3820 / 0.5045 / 0.3905,
mean 0.4257).  The band is that mean ± 2 standard
errors of a three-seed mean, 0.4272 ± 2 · 0.0847 / √3.
``chip_smoke.py`` holds the port on the card to the same band."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import make_classification  # noqa: E402
from repro_torch.engine import FLConfig, make_engine  # noqa: E402

REF_MEAN, REF_SD, SEEDS = 0.4272, 0.0847, (0, 1, 2)
BAND = (REF_MEAN - 2 * REF_SD / math.sqrt(len(SEEDS)), REF_MEAN + 2 * REF_SD / math.sqrt(len(SEEDS)))


@pytest.fixture
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    test's 90 small-MLP rounds from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_accuracy_within_the_reference_band(one_thread):
    train = make_classification(10_000, seed=0)
    test = make_classification(2_000, seed=1)
    gates = []
    for seed in SEEDS:
        cfg = FLConfig(n_clients=40, m=6, rounds=30, strategy="fedlecc", strategy_kwargs={"J": 4},
                       target_hd=0.85, eval_every=5, seed=seed)
        engine = make_engine(cfg, train, test, n_classes=10, device="cpu")
        evaluated = [r for r in engine.rounds() if r.evaluated]
        assert [r.round for r in evaluated] == [0, 5, 10, 15, 20, 25, 29]
        gates.append(np.mean([r.test_acc for r in evaluated[-3:]]))
    assert BAND[0] <= np.mean(gates) <= BAND[1], (gates, BAND)
