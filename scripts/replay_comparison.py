#!/usr/bin/env python
"""Long-run parity of the PyTorch port with the JAX package: each preset
at the paper's settings (K = 100, m = 10, MLP 784-200-200-10, shards at
target HD 0.9, 150 rounds, evaluation every 5, seed 0) runs in the
reference's ``HostEngine`` and in the port on the CPU, the port's
randomness replaced by the test suite's ``JaxReplayDraws``
(``tests/test_torch_engine.py``), which replays the reference's draws.
Prints, per preset, the rounds whose selection differs and the largest
test-accuracy difference over the evaluated rounds.  About 30 s a preset.

    PYTHONPATH=src:tests python scripts/replay_comparison.py [preset ...]
"""

from __future__ import annotations

import sys

from test_torch_engine import JaxReplayDraws

from repro.data import make_classification
from repro.engine import make_engine as ref_make_engine
from repro.engine.presets import get_preset
from repro_torch.engine import FLConfig, make_engine

PRESETS = ("fedavg", "fedprox", "fednova", "feddyn", "haccs", "fedcls", "fedcor", "poc",
           "fedlecc", "fedlecc_adaptive")


def main() -> None:
    train = make_classification(20_000, seed=0)
    test = make_classification(2_000, seed=1)
    for name in sys.argv[1:] or PRESETS:
        cfg = get_preset(name).make_config(
            n_clients=100, m=10, rounds=150, eval_every=5, partition="shards", target_hd=0.9,
            batch_size=64, lr=0.005, hidden=(200, 200), seed=0)
        want = list(ref_make_engine(cfg, train, test, n_classes=10).rounds())
        port = make_engine(FLConfig.from_dict(cfg.to_dict()), train, test, 10, device="cpu",
                           draws=JaxReplayDraws(cfg.seed, "cpu"))
        got = list(port.rounds())
        differ = [r.round for r, w in zip(got, want) if r.selected != w.selected]
        acc = max(abs(r.test_acc - w.test_acc) for r, w in zip(got, want) if r.evaluated)
        print(f"{name}: selections differ in {len(differ)} of {len(got)} rounds {differ}; "
              f"max |test_acc difference| {acc:.4f}", flush=True)


if __name__ == "__main__":
    main()
