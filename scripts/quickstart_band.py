#!/usr/bin/env python
"""The reference's spread on ``examples/quickstart.py``'s config, from
which ``tests/test_torch_quickstart.py`` and ``chip_smoke.py`` take the
accuracy band that holds the PyTorch port.

For each seed it runs the JAX package's ``HostEngine`` on the quickstart
config (40 clients, m = 6, 30 rounds, FedLECC J = 4, target HD 0.85,
10,000 / 2,000 samples, evaluation every 5 rounds) and prints the mean
test accuracy of the last three evaluated rounds (20, 25, 29); then the
mean and the sample standard deviation over the seeds.  About 2 s a seed
on a CPU.

    PYTHONPATH=src python scripts/quickstart_band.py --seeds 25
"""

from __future__ import annotations

import argparse
import statistics

from repro.data import make_classification
from repro.engine import FLConfig, make_engine


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=25, help="seeds 0 .. N-1")
    args = ap.parse_args()
    train = make_classification(10_000, seed=0)
    test = make_classification(2_000, seed=1)
    gates = []
    for seed in range(args.seeds):
        cfg = FLConfig(n_clients=40, m=6, rounds=30, strategy="fedlecc", strategy_kwargs={"J": 4},
                       target_hd=0.85, eval_every=5, seed=seed)
        accs = [r.test_acc for r in make_engine(cfg, train, test, n_classes=10).rounds()
                if r.evaluated]
        gates.append(statistics.fmean(accs[-3:]))
        print(f"seed {seed}: last evaluations {[round(a, 4) for a in accs[-3:]]}, "
              f"mean {gates[-1]:.4f}", flush=True)
    print(f"mean {statistics.fmean(gates):.4f}  sd {statistics.stdev(gates):.4f}  "
          f"over {len(gates)} seeds")


if __name__ == "__main__":
    main()
