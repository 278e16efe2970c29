#!/usr/bin/env python
"""How far the port's scale-out round on xlstm-125m at full width moves a
tiny change of its start weights, after one local step and after two: the
reason ``chip_smoke.py``'s grid runs xlstm-125m's round for one local step
(``GRID_MODEL_STEPS``), where a grid's sums in another order than a world
of one's are such a change.

It runs ``make_federated_round`` on a mesh of 2 pods in one process (the
whole layout), xlstm-125m cut to 4 layers in fp32, ``chip_smoke.py``'s
round settings (8 sequences of 128 tokens a pod, lr 0.05, FedAvg weights
0.25 / 0.75), twice a step count: from ``init_params``' weights and from
the same weights times (1 + eps N(0, 1)).  It prints each run's losses and
the largest difference of a leaf after the round, relative to max(1, the
leaf's largest |value|), as ``chip_smoke.py`` compares blocks.  About a
minute on a CPU.

``--branches``: the 2-step rounds again, every ``torch.maximum``, ``abs``,
``clamp``, ``isinf`` and ``cummax`` of ``repro_torch.models.ssm`` logged
(which branch each element takes), and for each call site the number of
decisions that differ between the two runs and the first call where one
does: where the two runs part.

``--reference``: the JAX package's own xlstm-125m (the same cut, its
``init_transformer`` weights, fp32) trained by plain SGD (lr 0.05) on 8
sequences of 128 tokens for three steps, from its weights and from them
times (1 + eps N(0, 1)): the largest leaf difference after each step, the
same measure.  It imports JAX.

    PYTHONPATH=src python scripts/xlstm_round_sensitivity.py --eps 1e-7 [--branches | --reference]
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import traceback

import torch


def _port(args) -> None:
    from torch.utils._pytree import tree_leaves, tree_map

    from repro_torch.configs import get_config
    from repro_torch.configs.inputs import dummy_batch
    from repro_torch.federated.scaleout import make_federated_round, stack_for_clients
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(get_config("xlstm-125m"), n_layers=args.layers, dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(5)
    moved = tree_map(lambda p: p * (1 + args.eps * torch.randn(p.shape, generator=g)), params)
    pods = [dummy_batch(cfg, 8, 128, seed=p) for p in range(2)]
    batch = {k: torch.stack([b[k] for b in pods]) for k in pods[0]}
    weights = torch.tensor((0.25, 0.75))
    for steps in ((2,) if args.branches else (1, 2)):
        fn = make_federated_round(cfg, make_host_mesh(pod=2), lr=0.05, local_steps=steps)
        logs = []
        with _Branches(args.branches) as log:
            a, la = fn(stack_for_clients(params, 2), batch, weights)
            logs.append(list(log))
            log.clear()
            b, lb = fn(stack_for_clients(moved, 2), batch, weights)
            logs.append(list(log))
        rel = max(((x[0] - y[0]).abs().max() / max(1.0, y[0].abs().max())).item()
                  for x, y in zip(tree_leaves(a), tree_leaves(b)))
        print(f"{steps} local step(s): losses {la.tolist()} / {lb.tolist()}; the largest leaf "
              f"difference after a {args.eps:g} relative change of the start weights, relative "
              f"to max(1, |leaf|): {rel:.3g}", flush=True)
        if args.branches:
            _report(*logs)


class _Branches(list):
    """Within the context, ``repro_torch.models.ssm``'s ``torch`` logs each
    branch decision (call site, the elements' choices) into this list."""

    def __init__(self, on: bool):
        super().__init__()
        self.on = on

    def __enter__(self):
        from repro_torch.models import ssm

        if self.on:
            self._torch, ssm.torch = ssm.torch, _Logging(self)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import ssm

        if self.on:
            ssm.torch = self._torch


class _Logging:
    def __init__(self, log):
        self.log = log

    def __getattr__(self, name):
        return getattr(torch, name)

    def _note(self, kind, choice):
        line = traceback.extract_stack(limit=3)[0].lineno
        self.log.append((f"{kind} at ssm.py:{line}", choice.detach().flatten().clone()))

    def maximum(self, a, b):
        self._note("maximum", a >= b)
        return torch.maximum(a, b)

    def abs(self, a):
        self._note("abs", a >= 0)
        return torch.abs(a)

    def clamp(self, a, min=None):
        self._note("clamp", a >= min)
        return torch.clamp(a, min=min)

    def isinf(self, a):
        out = torch.isinf(a)
        self._note("isinf", out)
        return out

    def cummax(self, a, dim):
        out = torch.cummax(a, dim=dim)
        self._note("cummax", out.indices)
        return out


def _report(a, b) -> None:
    if len(a) != len(b):
        raise AssertionError(f"the two runs made {len(a)} and {len(b)} logged calls")
    total, flipped, first = collections.Counter(), collections.Counter(), {}
    for i, ((site, x), (_, y)) in enumerate(zip(a, b)):
        total[site] += x.numel()
        n = int((x != y).sum())
        if n:
            flipped[site] += n
            first.setdefault(site, i)
    print(f"{len(a)} logged calls in each run", flush=True)
    for site in total:
        print(f"  {site}: {flipped[site]} of {total[site]} decisions differ"
              + (f", first at call {first[site]}" if site in first else ""), flush=True)


def _reference(args) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config
    from repro.models import transformer as tf

    cfg = dataclasses.replace(get_config("xlstm-125m"), n_layers=args.layers, dtype="float32")
    p = tf.init_transformer(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(5)
    moved = jax.tree.map(
        lambda a: a * (1 + args.eps * jnp.asarray(rng.standard_normal(a.shape), a.dtype)), p)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (8, 129)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}

    def loss(params):
        return tf.loss_fn(params, cfg, batch)[0]

    step = jax.jit(lambda q: jax.tree.map(lambda a, g: a - 0.05 * g, q, jax.grad(loss)(q)))
    a, b = p, moved
    for s in (1, 2, 3):
        a, b = step(a), step(b)
        rel = max(float(jnp.abs(x - y).max() / max(1.0, float(jnp.abs(y).max())))
                  for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
        print(f"the reference's SGD, {s} step(s): the largest leaf difference after a "
              f"{args.eps:g} relative change of the start weights, relative to max(1, |leaf|): "
              f"{rel:.3g}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--eps", type=float, default=1e-7)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--branches", action="store_true")
    ap.add_argument("--reference", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(8)
    (_reference if args.reference else _port)(args)


if __name__ == "__main__":
    main()
