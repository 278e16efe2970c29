"""The optimizer substrate, ported from ``repro.optim``: ``Optimizer`` is an
``(init, update)`` pair over parameter trees whose ``update`` returns the
updates to add (already scaled by -lr), with SGD, AdamW, gradient
clipping, ``chain`` and the learning-rate schedules of the training
launcher; and the local-objective modifiers of the paper's
regularization baselines (``fedmods``: FedProx, FedDyn)."""

from repro_torch.optim.fedmods import feddyn_grads, feddyn_update_state, fedprox_grads
from repro_torch.optim.optimizers import Optimizer, adamw, chain, clip_by_global_norm, sgd
from repro_torch.optim.schedules import constant, warmup_cosine

__all__ = [
    "Optimizer",
    "sgd",
    "adamw",
    "chain",
    "clip_by_global_norm",
    "constant",
    "warmup_cosine",
    "fedprox_grads",
    "feddyn_grads",
    "feddyn_update_state",
]
