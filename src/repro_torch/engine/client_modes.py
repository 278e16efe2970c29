"""Local-objective client modes as registered objects, ported from
``repro.engine.client_modes``.

A client mode is the third axis of a federated method (after selection
and aggregation): a gradient transform applied inside each local SGD
step, plus optional per-client state.

    modify_grads(grads, params, global_params, h_state, mu) -> grads
    init_client_state(global_params, n_clients)  -> (K, P) state or None
    update_client_state(h_sel, local_params_end, new_global, mu) -> h_sel

Here ``grads``, ``params`` and ``h_state`` are (m, P) cohort tensors and
the transforms work in place (``repro_torch.optim.fedmods``).
"""

from __future__ import annotations

import torch

from repro_torch.engine.registry import CLIENT_MODE_REGISTRY, register_client_mode
from repro_torch.optim.fedmods import feddyn_grads, feddyn_update_state, fedprox_grads

__all__ = ["ClientMode", "PlainMode", "FedProxMode", "FedDynMode", "get_client_mode"]


class ClientMode:
    """Base: unmodified local SGD (what FedAvg and every selection-only
    method use)."""

    name = "plain"
    needs_h = False  # per-client correction state (FedDyn)?

    def modify_grads(self, grads, params, global_params, h_state, mu: float):
        return grads

    def init_client_state(self, global_params: torch.Tensor, n_clients: int):
        return None

    def update_client_state(self, h_sel, local_params_end, new_global, mu: float):
        return h_sel


@register_client_mode("plain")
class PlainMode(ClientMode):
    name = "plain"


@register_client_mode("fedprox")
class FedProxMode(ClientMode):
    """FedProx: + (mu/2)·‖θ − θ_g‖² proximal term."""

    name = "fedprox"

    def modify_grads(self, grads, params, global_params, h_state, mu: float):
        return fedprox_grads(grads, params, global_params, mu)


@register_client_mode("feddyn")
class FedDynMode(ClientMode):
    """FedDyn: linear-dual correction ⟨h_i, θ⟩ with per-client h_i state,
    a (K, P) fp32 tensor on the parameters' device."""

    name = "feddyn"
    needs_h = True

    def modify_grads(self, grads, params, global_params, h_state, mu: float):
        return feddyn_grads(grads, params, global_params, h_state, mu)

    def init_client_state(self, global_params: torch.Tensor, n_clients: int):
        return torch.zeros((n_clients,) + tuple(global_params.shape), dtype=torch.float32,
                           device=global_params.device)

    def update_client_state(self, h_sel, local_params_end, new_global, mu: float):
        return feddyn_update_state(h_sel, local_params_end, new_global, mu)


def get_client_mode(name: str) -> ClientMode:
    """A registered client mode (modes are stateless; the engine threads
    the per-client state)."""
    return CLIENT_MODE_REGISTRY.build(name)
