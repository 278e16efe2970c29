"""The port's one source of randomness.

Every random draw of a run goes through a ``draws`` object, whose methods
are the counterparts of the reference's ``jax.random`` call sites:

- ``init_params(spec)`` -> flat (P,) fp32 initial parameters of the
  model the task names by ``spec``: the MLP's layer sizes (a tuple,
  ``repro.models.mlp.init_mlp``) or a transformer's ``ModelConfig``
  (``repro.models.transformer.init_transformer``);
- ``poll_indices(rnd, probs, n)`` -> (K, n) int64 sample indices per
  client for the loss poll (``Engine._poll_losses`` in the reference);
- ``batch_indices(rnd, clients, probs, steps, batch)`` -> (steps, m,
  batch) int64 minibatch indices per step and client (``local_train``'s
  ``_sample_batch`` with the per-client ``fold_in``);
- ``client_batch_indices(rnd, probs, steps, batch)`` -> (steps, K, batch)
  int64 minibatch indices of every client, whatever the cohort (the
  compiled backend's draw: the reference folds the client index into the
  round's key, ``Engine._client_keys``), so a cohort gathered on the
  device finds its rows without a host read;
- ``selection_noise(rnd, kind, n_clients, n_clusters)`` -> the tuple of
  tensors a strategy's ``select_mask_traced`` takes for ``kind``
  (``SelectionStrategy.traced_noise``): ``"uniform"`` (K,) fp32 scores,
  ``"gumbel"`` (K,) fp32 Gumbel noise, ``"permutations"`` a permutation of
  the clusters and one of the clients (the reference draws them from
  ``fold_in(k_poll, K)``);
- ``quant_uniforms(rnd, m, start, stop)`` -> (m, stop - start) fp32
  uniforms in [0, 1) for columns [start, stop) of the round's (m, P)
  stochastic rounding (``compress_bits``; the reference's
  ``fold_in(k_train, K)`` stream), asked for column block by column
  block in increasing order.

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
    seed see identical indices, initial weights and selection noise.  The
    quantization uniforms, (m, P) a round, come from a third generator on
    ``device`` (host draws and their copy would cost more than the round),
    so a CPU run and a CUDA run of ``compress_bits`` round differently."""

    def __init__(self, seed: int, device: str | torch.device):
        self.device = torch.device(device)
        self._init = torch.Generator().manual_seed(int(seed))
        self._rounds = torch.Generator().manual_seed(int(seed) + 17)
        self._quant = torch.Generator(self.device).manual_seed(int(seed) + 29)

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

    def client_batch_indices(self, rnd: int, probs: torch.Tensor, steps: int,
                             batch: int) -> torch.Tensor:
        k = probs.shape[0]
        idx = torch.multinomial(probs.cpu(), steps * batch, replacement=True,
                                generator=self._rounds)
        return idx.view(k, steps, batch).transpose(0, 1).contiguous().to(self.device)

    def selection_noise(self, rnd: int, kind: str | None, n_clients: int,
                        n_clusters: int) -> tuple[torch.Tensor, ...]:
        if kind is None:
            return ()
        if kind == "uniform":
            return (torch.rand(n_clients, generator=self._rounds).to(self.device),)
        if kind == "gumbel":
            u = torch.rand(n_clients, generator=self._rounds)
            u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
            return ((-torch.log(-torch.log(u))).to(self.device),)
        if kind == "permutations":
            return (torch.randperm(n_clusters, generator=self._rounds).to(self.device),
                    torch.randperm(n_clients, generator=self._rounds).to(self.device))
        raise ValueError(f"unknown selection noise {kind!r}")

    def quant_uniforms(self, rnd: int, m: int, start: int, stop: int) -> torch.Tensor:
        return torch.rand((m, stop - start), generator=self._quant, device=self.device)

    def graph_generators(self) -> list[torch.Generator]:
        """The generators on the device that a round body draws from."""
        return [self._quant]
