"""SGD, AdamW and gradient clipping over parameter trees, ported from
``repro.optim.optimizers``.

An ``Optimizer`` is an ``(init, update)`` pair over trees of tensors
(dicts, lists and tuples).  ``update(grads, state, params)`` returns the
updates to *add* to the parameters (already scaled by -lr) and the new
state, and ``apply_updates`` adds them, as in the reference.

The arithmetic is the reference's, operation for operation: AdamW keeps
fp32 moments whatever the parameter's type, corrects their bias with the
incremented count, steps by ``(m / bc1) / (sqrt(v / bc2) + eps)`` plus the
weight decay on the fp32 parameter, and casts the update to the
parameter's type; ``apply_updates`` adds in the parameter's type.  The
moments (and SGD's momentum) advance in place, leaf by leaf: the reference
donates its optimizer state to the step, and at full size a second copy
of AdamW's two fp32 trees would cost 8 bytes a parameter.  So the state
passed in is the state returned, and must not be reused after the call.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

__all__ = ["Optimizer", "sgd", "adamw", "clip_by_global_norm", "chain", "apply_updates"]

Schedule = Callable[[torch.Tensor], torch.Tensor] | float


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]  # (grads, state, params)


def _lr_at(lr: Schedule, count: torch.Tensor) -> torch.Tensor:
    return lr(count) if callable(lr) else torch.tensor(lr, dtype=torch.float32,
                                                      device=count.device)


def _count(params) -> torch.Tensor:
    """A zero int32 step count on the device of the first leaf."""
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None)


def _times_f32(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """t times the fp32 0-d tensor s, in fp32, rounded back to t's type: a
    bf16 leaf times a fp32 array promotes to fp32 in JAX, where PyTorch
    would round s to bf16 first."""
    return (t.to(torch.float32) * s).to(t.dtype)


def _weak(x: float, t: torch.Tensor) -> torch.Tensor:
    """A Python number as JAX's weak type puts it against t: in t's type."""
    return torch.tensor(x, dtype=t.dtype, device=t.device)


def sgd(lr: Schedule, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    """SGD, optionally with (Nesterov) momentum.  The paper trains with
    plain SGD(lr=0.005): momentum defaults off."""

    def init(params):
        mu = tree_map(torch.zeros_like, params) if momentum else ()
        return {"count": _count(params), "mu": mu}

    @torch.no_grad()
    def update(grads, state, params=None):
        del params
        step = _lr_at(lr, state["count"])
        if momentum:
            mu = tree_map(lambda m, g: m.mul_(_weak(momentum, m)).add_(g), state["mu"], grads)
            eff = (tree_map(lambda m, g: _weak(momentum, m) * m + g, mu, grads) if nesterov
                   else mu)
        else:
            mu, eff = (), grads
        updates = tree_map(lambda g: _times_f32(g, -step), eff)
        return updates, {"count": state["count"] + 1, "mu": mu}

    return Optimizer(init, update)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with fp32 moments regardless of the parameters' type."""

    def init(params):
        def f32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"count": _count(params), "m": tree_map(f32, params), "v": tree_map(f32, params)}

    @torch.no_grad()
    def update(grads, state, params):
        c = state["count"] + 1
        step = _lr_at(lr, state["count"])
        bc1 = 1 - b1 ** c.to(torch.float32)
        bc2 = 1 - b2 ** c.to(torch.float32)

        def one(m_, v_, g, p):
            g = g.to(torch.float32)
            m_.mul_(b1).add_((1 - b1) * g)
            v_.mul_(b2).add_((1 - b2) * torch.square(g))
            adam = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            return (-step * (adam + weight_decay * p.to(torch.float32))).to(p.dtype)

        updates = tree_map(one, state["m"], state["v"], grads, params)
        return updates, {"count": c, "m": state["m"], "v": state["v"]}

    return Optimizer(init, update)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    """Gradient transform: rescale the gradients so that their global L2
    norm (squares summed in fp32 over every leaf) is at most ``max_norm``."""

    def init(params):
        del params
        return ()

    @torch.no_grad()
    def update(grads, state, params=None):
        del params
        leaves = tree_leaves(grads)
        sq = torch.stack([torch.sum(torch.square(g.to(torch.float32))) for g in leaves]).sum()
        norm = torch.sqrt(sq)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return tree_map(lambda g: _times_f32(g, scale), grads), state

    return Optimizer(init, update)


def chain(*transforms: Optimizer) -> Optimizer:
    """Compose gradient transforms left to right (the last one produces
    the updates)."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s2 = t.update(grads, s, params)
            new_state.append(s2)
        return grads, tuple(new_state)

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    """theta <- theta + updates (the updates already carry the -lr
    scaling), added in each parameter's type."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)

