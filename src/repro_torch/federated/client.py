"""Client-side local training over the whole cohort at once, ported from
``repro.federated.client.local_train``.

The reference vmaps one client's ``lax.scan`` of SGD steps over the
cohort; here the client axis is explicit.  The m models are one (m, P)
tensor, and each step is one forward over per-client views and one
autograd call on the *sum* of the per-client mean losses: row i of its
gradient is exactly client i's own gradient, since no other term depends
on row i.  The scan becomes a Python loop over ``max_steps``; a client
whose budget ``tau`` is spent keeps its parameters (``live = t < tau``),
and the mean loss divides by ``max(min(tau, max_steps), 1)``, both as in
the reference.  The update is applied in place, under ``torch.no_grad``,
to the cohort tensor; the step is scaled in the gradient's own buffer,
so the update allocates no further (m, P) tensor, which matters when
the cohort is 15 GB.  Rows are examples: feature vectors for classification, whole
token sequences for the LM task.

A client mode (``repro_torch.engine.client_modes``: ``plain``,
``fedprox``, ``feddyn``) transforms the gradient before the ``live``
gate, as the reference's scan step does, in the gradient's own buffer;
``feddyn`` also reads the cohort's (m, P) ``h_state``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.engine.client_modes import get_client_mode

__all__ = ["client_loss", "local_train"]


def client_loss(apply_fn: Callable, loss_fn: Callable, params, x, y, mask) -> torch.Tensor:
    """Local empirical loss over the client's full (masked) dataset: what
    each client reports to the server (Algorithm 1 line 3)."""
    return loss_fn(apply_fn(params, x), y, mask)


def local_train(
    apply_fn: Callable,
    loss_fn: Callable,
    global_params: torch.Tensor,  # (P,)
    x: torch.Tensor,              # (m, N_max, ...) padded cohort features / tokens
    y: torch.Tensor,              # (m, N_max, ...) padded labels / next tokens
    batch_idx: torch.Tensor,      # (max_steps, m, batch) row indices
    tau: torch.Tensor,            # (m,) true local step budgets
    lr: float,
    max_steps: int,
    mode: str = "plain",                 # plain | fedprox | feddyn
    mu: float = 0.0,                     # fedprox mu / feddyn alpha
    h_state: torch.Tensor | None = None,  # (m, P) feddyn per-client correction
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (params_end (m, P), mean train loss over executed steps (m,))."""
    mode_impl = get_client_mode(mode)
    m = x.shape[0]
    rows = torch.arange(m, device=x.device)[:, None]
    theta = global_params.expand(m, -1).clone().requires_grad_(True)
    loss_sum = torch.zeros(m, dtype=torch.float32, device=x.device)
    for t in range(max_steps):
        bidx = batch_idx[t]
        loss = loss_fn(apply_fn(theta, x[rows, bidx]), y[rows, bidx], None)  # (m,)
        (grad,) = torch.autograd.grad(loss.sum(), theta)
        live = (t < tau).to(torch.float32)
        with torch.no_grad():
            grad = mode_impl.modify_grads(grad, theta, global_params, h_state, mu)
            theta -= grad.mul_((lr * live)[:, None])
            loss_sum += live * loss
    mean_loss = loss_sum / torch.clamp(torch.clamp(tau, max=max_steps).to(torch.float32), min=1.0)
    return theta.detach(), mean_loss
