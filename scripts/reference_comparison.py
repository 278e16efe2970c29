#!/usr/bin/env python
"""The reference's side of ``chip_smoke.py``'s comparison phase: the JAX
package's ``HostEngine`` runs each classification preset at the paper's
settings (K = 100, m = 10, MLP 784-200-200-10, shards at target HD 0.9,
batch 64, lr 0.005, 150 rounds, evaluation every 5, seed 0) and prints its
final test accuracy, the first evaluated round at 50 % accuracy, the MB
billed and the range of its last eight evaluations (the curve's swing).  Its randomness is JAX's, the port's is ``TorchDraws``: the two
sides agree in distribution, not draw for draw.  Seconds a preset on a CPU.

    PYTHONPATH=src python scripts/reference_comparison.py [preset ...]
"""

from __future__ import annotations

import sys

from repro.data import make_classification
from repro.engine import make_engine, rounds_to_accuracy
from repro.engine.presets import get_preset

PRESETS = ("fedavg", "fedprox", "fednova", "feddyn", "haccs", "fedcls", "fedcor", "poc",
           "fedlecc", "fedlecc_adaptive")


def main() -> None:
    train = make_classification(20_000, seed=0)
    test = make_classification(2_000, seed=1)
    for name in sys.argv[1:] or PRESETS:
        cfg = get_preset(name).make_config(
            n_clients=100, m=10, rounds=150, eval_every=5, partition="shards", target_hd=0.9,
            batch_size=64, lr=0.005, hidden=(200, 200), seed=0)
        history = make_engine(cfg, train, test, n_classes=10).run()
        last = history["test_acc"][-8:]
        print(f"{name}: final test_acc {history['test_acc'][-1]:.4f}  rounds to 50 % "
              f"{rounds_to_accuracy(history, 0.5)}  comm {history['comm_mb'][-1]:.2f} MB  "
              f"last 8 evaluations {min(last):.4f}-{max(last):.4f}", flush=True)


if __name__ == "__main__":
    main()
