"""Local-objective modifiers of the paper's regularization baselines
(``fedmods``: FedProx, FedDyn), ported from ``repro.optim``.  The
reference's optimizers and schedules serve its training launcher, which
the port does not have yet."""

from repro_torch.optim.fedmods import feddyn_grads, feddyn_update_state, fedprox_grads

__all__ = ["fedprox_grads", "feddyn_grads", "feddyn_update_state"]
