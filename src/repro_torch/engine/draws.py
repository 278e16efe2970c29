"""The port's one source of randomness.

Every random draw of a run goes through a ``draws`` object with three
methods, the counterparts of the reference's ``jax.random`` call sites:

- ``init_params(spec)`` -> flat (P,) fp32 initial parameters of the
  model the task names by ``spec``: the MLP's layer sizes (a tuple,
  ``repro.models.mlp.init_mlp``) or a transformer's ``ModelConfig``
  (``repro.models.transformer.init_transformer``);
- ``poll_indices(rnd, probs, n)`` -> (K, n) int64 sample indices per
  client for the loss poll (``Engine._poll_losses`` in the reference);
- ``batch_indices(rnd, clients, probs, steps, batch)`` -> (steps, m,
  batch) int64 minibatch indices per step and client (``local_train``'s
  ``_sample_batch`` with the per-client ``fold_in``).

``probs`` rows are the clients' validity masks normalized to sum 1;
indices are drawn with replacement.  ``TorchDraws`` is the default.  A
test can pass any object with these methods to ``make_engine(...,
draws=...)``; the parity tests pass one that replays the reference's
JAX key chain, which makes rounds comparable draw for draw.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.models.mlp import init_mlp
from repro_torch.models.transformer import init_transformer

__all__ = ["TorchDraws"]


class TorchDraws:
    """Draws from two explicit CPU ``torch.Generator``s (initialisation,
    and the rounds), consumed in call order; results are moved to
    ``device``.  Drawing on the host makes a CPU run and a CUDA run of one
    seed see identical indices and initial weights."""

    def __init__(self, seed: int, device: str | torch.device):
        self.device = torch.device(device)
        self._init = torch.Generator().manual_seed(int(seed))
        self._rounds = torch.Generator().manual_seed(int(seed) + 17)

    def init_params(self, spec: tuple[int, ...] | ModelConfig) -> torch.Tensor:
        if isinstance(spec, ModelConfig):
            return init_transformer(self._init, spec).to(self.device)
        return init_mlp(self._init, spec).to(self.device)

    def poll_indices(self, rnd: int, probs: torch.Tensor, n: int) -> torch.Tensor:
        idx = torch.multinomial(probs.cpu(), n, replacement=True, generator=self._rounds)
        return idx.to(self.device)

    def batch_indices(self, rnd: int, clients: np.ndarray, probs: torch.Tensor,
                      steps: int, batch: int) -> torch.Tensor:
        m = probs.shape[0]
        idx = torch.multinomial(probs.cpu(), steps * batch, replacement=True,
                                generator=self._rounds)
        return idx.view(m, steps, batch).transpose(0, 1).contiguous().to(self.device)
