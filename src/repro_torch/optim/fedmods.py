"""FedProx and FedDyn as gradient transforms over the flat cohort, ported
from ``repro.optim.fedmods``.

FedProx  (Li et al., 2020):   + (mu/2)·‖θ − θ_g‖²
    → grads += mu · (θ − θ_g)

FedDyn   (Acar et al., 2021): − ⟨h_i, θ⟩ + (a/2)·‖θ − θ_g‖²
    → grads += −h_i + a · (θ − θ_g)
    with per-client state   h_i ← h_i − a · (θ_local_end − θ_g)

``grads``, ``params`` and ``h_state`` are (m, P) cohort tensors and
``global_params`` is (P,).  The transforms write into ``grads`` (and the
update into ``h_state``) and return it: at LM width the cohort is 15 GB,
so no step may allocate another (m, P) tensor.  ``a·θ − a·θ_g`` is the
reference's ``a·(θ − θ_g)`` summed in another order.
"""

from __future__ import annotations

import torch

__all__ = ["fedprox_grads", "feddyn_grads", "feddyn_update_state"]


def fedprox_grads(grads: torch.Tensor, params: torch.Tensor, global_params: torch.Tensor,
                  mu: float) -> torch.Tensor:
    return grads.add_(params, alpha=mu).sub_(global_params, alpha=mu)


def feddyn_grads(grads: torch.Tensor, params: torch.Tensor, global_params: torch.Tensor,
                 h_state: torch.Tensor, alpha: float) -> torch.Tensor:
    return grads.sub_(h_state).add_(params, alpha=alpha).sub_(global_params, alpha=alpha)


def feddyn_update_state(h_state: torch.Tensor, local_params_end: torch.Tensor,
                        global_params: torch.Tensor, alpha: float) -> torch.Tensor:
    """Per-client h_i update after local training, in ``h_state``'s buffer."""
    return h_state.sub_(local_params_end, alpha=alpha).add_(global_params, alpha=alpha)
