#!/usr/bin/env python
"""How many dispatched clients lie outside a round's resident shards, in
the JAX package's engine, on ``benchmarks/bench_population.py``'s training
row at K = 10^3 (15 shards, 4 resident, fedlecc J = 5, m = 32).

Algorithm 1 ranks clusters by the mean of their finite (resident) losses
and takes the top ``ceil(m / J)`` clients of each top cluster by loss; a
cluster with fewer resident members than that also gives up non-resident
ones (``-inf`` losses sort last but are still taken).  The port keeps
this rule, so ``chip_smoke.py``'s population rows count the same thing
there.  Prints one line a round and the total; a few seconds on a CPU.

    PYTHONPATH=src python scripts/population_residency.py --rounds 4
"""

from __future__ import annotations

import argparse

from repro.data import make_classification
from repro.engine import FLConfig, make_engine


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    k = 1_000
    train = make_classification(32 * k, n_features=64, n_classes=10, seed=0)
    test = make_classification(1_000, n_features=64, n_classes=10, seed=1)
    cfg = FLConfig(n_clients=k, m=32, rounds=args.rounds, seed=0, strategy="fedlecc",
                   strategy_kwargs={"J": 5}, hidden=(64,), eval_samples=16, eval_every=1,
                   target_hd=0.8, batch_size=16, local_epochs=2, lr=0.05,
                   population={"n_shards": 15, "shards_per_round": 4, "j_shards": 3})
    engine = make_engine(cfg, train, test, n_classes=10)
    total = 0
    for r in engine.rounds():
        outside = len(set(r.selected) - set(engine._pop_members.tolist()))
        total += outside
        print(f"round {r.round}: {outside} of {len(r.selected)} dispatched outside the "
              f"{len(engine._pop_members)} resident clients", flush=True)
    print(f"total: {total} of {cfg.m * cfg.rounds}")


if __name__ == "__main__":
    main()
