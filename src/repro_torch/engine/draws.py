"""The port's one source of randomness.

Every random draw of a run goes through a ``draws`` object, whose methods
are the counterparts of the reference's ``jax.random`` call sites:

- ``init_params(spec)`` -> flat (P,) fp32 initial parameters of the
  model the task names by ``spec``: the MLP's layer sizes (a tuple,
  ``repro.models.mlp.init_mlp``) or a transformer's ``ModelConfig``
  (``repro.models.transformer.init_transformer``);
- ``poll_indices(rnd, probs, n, clients=None)`` -> (K, n) int64 sample
  indices per client for the loss poll (``Engine._poll_losses`` in the
  reference); with ``clients`` (global client ids, the population
  axis's resident members) the poll of just those clients, ``probs``
  being their rows, each client's indices the ones the flat poll draws
  for it (the reference's ``_poll_subset``);
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
indices are drawn with replacement.  An engine without a population
calls ``bind_rows(probs)`` once at setup when its draws have that method
(with one, the rows passed to each draw build its table, so the device
holds no (K, N_max) table), and checkpoints
``state()`` (restored by ``load_state``) when they have that one.  The
``rnd`` of these methods is a draw index: the round, or the dispatch
count under the async runtime.  ``TorchDraws`` is the
default.  A test can pass any object with these methods to
``make_engine(..., draws=...)``; the parity tests pass one that replays
the reference's JAX key chain, which makes rounds comparable draw for
draw.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.models.mlp import init_mlp
from repro_torch.models.transformer import init_transformer

__all__ = ["TorchDraws", "counter_hash"]

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1, _MIX2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB
# the streams of a round: the loss poll's rows, the minibatch rows, the
# selection noise
POLL, BATCH, NOISE = 1, 2, 3


def _signed(c: int) -> int:
    """A 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (``>>`` on int64 is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64's finaliser on int64 bits; products wrap modulo 2^64."""
    x = x ^ _lsr(x, 30)
    x = x * _signed(_MIX1)
    x = x ^ _lsr(x, 27)
    x = x * _signed(_MIX2)
    return x ^ _lsr(x, 31)


def _fold(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """mix(h + (v + 1) * golden): a new key for each counter ``v``."""
    return _mix(h + (v + 1) * _signed(_GOLDEN))


def _mix_int(x: int) -> int:
    x &= _M64
    x ^= x >> 30
    x = (x * _MIX1) & _M64
    x ^= x >> 27
    x = (x * _MIX2) & _M64
    return x ^ (x >> 31)


def _fold_int(h: int, v: int) -> int:
    return _mix_int(h + (v + 1) * _GOLDEN)


def counter_hash(seed: int, rnd: int, stream: int, client: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """64 hashed bits (as int64) for each (client, position) pair, which
    broadcast against each other: mix-fold the seed, the stream and the
    round into one key on the host, then fold in the client and then the
    position on the tensors' device.  The bits depend on nothing else, so
    a draw does not depend on the draws before it or on the cohort."""
    key = _signed(_fold_int(_fold_int(_fold_int(0, seed), stream), rnd))
    return _fold(_fold(torch.full_like(client, key), client), pos)


class TorchDraws:
    """Draws keyed by (seed, round, stream, client, position) through
    ``counter_hash``: int64 ops on ``device`` that give the same bits on
    the CPU and the card, so a CPU run and a CUDA run of one seed, and a
    host run and a compiled run, see identical indices and selection noise.
    A row is ``valid[(h32 * n) >> 32]``: 32 hashed bits scaled to the
    client's n valid rows with no floating point, looked up in a (K,
    max_rows) table of valid row positions.  The initial weights come from
    a CPU generator.  The quantization uniforms, (m, P) a round, come from
    a generator on ``device`` (registered with each captured graph), so a
    CPU run and a CUDA run of ``compress_bits`` round differently."""

    def __init__(self, seed: int, device: str | torch.device):
        self.device = torch.device(device)
        self.seed = int(seed)
        self._init = torch.Generator().manual_seed(self.seed)
        self._quant = torch.Generator(self.device).manual_seed(self.seed + 29)
        self._rows: tuple[torch.Tensor, torch.Tensor] | None = None

    def init_params(self, spec: tuple[int, ...] | ModelConfig) -> torch.Tensor:
        if isinstance(spec, ModelConfig):
            return init_transformer(self._init, spec).to(self.device)
        return init_mlp(self._init, spec).to(self.device)

    def _row_table(self, probs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(K,) valid-row counts and the (K, max_rows) table whose row k
        starts with client k's valid row positions, in increasing order."""
        valid = probs.detach().cpu() > 0
        table = torch.sort((~valid).to(torch.int8), dim=1, stable=True).indices
        return valid.sum(1).to(self.device), table.to(self.device)

    def bind_rows(self, probs: torch.Tensor) -> None:
        """Build the row table of every client once; later draws pass
        ``probs`` of the same clients and read this table."""
        self._rows = self._row_table(probs)

    def _draw_rows(self, rnd: int, stream: int, clients: torch.Tensor, probs: torch.Tensor,
                   n: int) -> torch.Tensor:
        """(len(clients), n) row indices of ``clients``."""
        if self._rows is None:
            counts, table = self._row_table(probs)
        else:
            counts, table = (t[clients] for t in self._rows)
        pos = torch.arange(n, device=self.device)
        h = counter_hash(self.seed, rnd, stream, clients[:, None], pos[None, :])
        idx = (_lsr(h, 32) * counts[:, None]) >> 32
        return torch.gather(table, 1, idx)

    def poll_indices(self, rnd: int, probs: torch.Tensor, n: int,
                     clients: np.ndarray | None = None) -> torch.Tensor:
        if clients is None:
            clients = torch.arange(probs.shape[0], device=self.device)
        else:
            clients = torch.as_tensor(np.asarray(clients), dtype=torch.int64,
                                      device=self.device)
        return self._draw_rows(rnd, POLL, clients, probs, n)

    def _batch_rows(self, rnd: int, clients: torch.Tensor, probs: torch.Tensor, steps: int,
                    batch: int) -> torch.Tensor:
        idx = self._draw_rows(rnd, BATCH, clients, probs, steps * batch)
        return idx.view(len(clients), steps, batch).transpose(0, 1).contiguous()

    def batch_indices(self, rnd: int, clients: np.ndarray, probs: torch.Tensor,
                      steps: int, batch: int) -> torch.Tensor:
        clients = torch.as_tensor(np.asarray(clients), dtype=torch.int64, device=self.device)
        return self._batch_rows(rnd, clients, probs, steps, batch)

    def client_batch_indices(self, rnd: int, probs: torch.Tensor, steps: int,
                             batch: int) -> torch.Tensor:
        clients = torch.arange(probs.shape[0], device=self.device)
        return self._batch_rows(rnd, clients, probs, steps, batch)

    def _noise_bits(self, rnd: int, sub: int, n: int) -> torch.Tensor:
        pos = torch.arange(n, device=self.device)
        return counter_hash(self.seed, rnd, NOISE, torch.full((), sub, device=self.device), pos)

    def selection_noise(self, rnd: int, kind: str | None, n_clients: int,
                        n_clusters: int) -> tuple[torch.Tensor, ...]:
        if kind is None:
            return ()
        if kind in ("uniform", "gumbel"):
            # 24 hashed bits: exact in fp32, the same on every device
            u = (_lsr(self._noise_bits(rnd, 0, n_clients), 40)).to(torch.float32) * 2.0 ** -24
            if kind == "uniform":
                return (u,)
            u = torch.clamp(u, min=torch.finfo(torch.float32).tiny).to(torch.float64)
            return ((-torch.log(-torch.log(u))).to(torch.float32),)
        if kind == "permutations":
            return tuple(torch.sort(self._noise_bits(rnd, sub, n), stable=True).indices
                         for sub, n in ((1, n_clusters), (2, n_clients)))
        raise ValueError(f"unknown selection noise {kind!r}")

    def quant_uniforms(self, rnd: int, m: int, start: int, stop: int) -> torch.Tensor:
        return torch.rand((m, stop - start), generator=self._quant, device=self.device)

    def graph_generators(self) -> list[torch.Generator]:
        """The generators on the device that a round body draws from."""
        return [self._quant]

    def state(self) -> torch.Tensor:
        """What the draws carry from round to round, for a checkpoint: the
        quantization generator's state (a CPU uint8 tensor).  The counter
        hashes carry nothing, and the initial weights are drawn once."""
        return self._quant.get_state()

    def load_state(self, state: torch.Tensor) -> None:
        self._quant.set_state(state.to("cpu"))
