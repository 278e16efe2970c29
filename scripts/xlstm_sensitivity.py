#!/usr/bin/env python
"""How far the reference's own xLSTM LM training moves a tiny change of
its initial weights: the reason the port's xlstm parity tests
(``tests/test_torch_xlstm.py``) and ``chip_smoke.py``'s xlstm agreement
start each round from the other side's parameters.

It runs the JAX package's ``HostEngine`` on the 4-layer "MMMS" xlstm
micro config (d_model 32, vocab 32, 8 clients, m = 3, batch 4, up to 3
local steps) over 48 token sequences of ``--seq`` tokens, twice: from the
initial weights and from the same weights times (1 + eps N(0, 1)).  For
each round it prints both test losses and their difference, then the
largest parameter difference after the last round.  The dense stablelm
micro config runs alongside for contrast.  About 20 s on a CPU.

    PYTHONPATH=src python scripts/xlstm_sensitivity.py --seq 16 --eps 1e-6
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp

from repro.data.synthetic import make_token_stream
from repro.engine import FLConfig, make_engine

MODELS = {
    "xlstm": {"model": "xlstm-125m", "hist_bins": 16,
              "overrides": {"n_layers": 4, "d_model": 32, "vocab": 32, "loss_chunk": 16}},
    "stablelm": {"model": "stablelm-3b", "hist_bins": 16,
                 "overrides": {"d_model": 32, "n_heads": 2, "n_kv_heads": 2, "head_dim": 16,
                               "d_ff": 64, "vocab": 32, "loss_chunk": 16, "attn_chunk": 16,
                               "remat": False}},
}


def _run(task_kwargs, train, test, eps, rounds):
    cfg = FLConfig(task="lm", task_kwargs=task_kwargs, n_clients=8, m=3, rounds=rounds,
                   strategy_kwargs={"J": 2}, batch_size=4, eval_samples=4, eval_every=1,
                   target_hd=0.8, max_steps_cap=3, seed=0)
    engine = make_engine(cfg, train, test, n_classes=32)
    leaves, tree = jax.tree.flatten(engine.params)
    key = jax.random.PRNGKey(3)
    engine.params = jax.tree.unflatten(tree, [
        leaf * (1 + eps * jax.random.normal(jax.random.fold_in(key, i), leaf.shape))
        for i, leaf in enumerate(leaves)])
    losses = [r.test_loss for r in engine.rounds()]
    return losses, engine.params


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=16, help="tokens a sequence")
    ap.add_argument("--eps", type=float, default=1e-6, help="relative weight perturbation")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    train = make_token_stream(48, args.seq, 32, seed=0)
    test = make_token_stream(16, args.seq, 32, seed=1)
    for name, task_kwargs in MODELS.items():
        base, p0 = _run(task_kwargs, train, test, 0.0, args.rounds)
        moved, p1 = _run(task_kwargs, train, test, args.eps, args.rounds)
        for rnd, (a, b) in enumerate(zip(base, moved)):
            print(f"{name} S={args.seq} eps={args.eps:g} round {rnd}: test loss {a:.6f} "
                  f"against {b:.6f}, |diff| {abs(a - b):.3g}")
        diff = max(float(jnp.abs(x - y).max()) for x, y in zip(jax.tree.leaves(p0),
                                                               jax.tree.leaves(p1)))
        print(f"{name} S={args.seq} eps={args.eps:g}: max |params diff| after round "
              f"{args.rounds - 1}: {diff:.3g}")


if __name__ == "__main__":
    main()
