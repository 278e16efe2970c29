"""FusedEngine — chunks of rounds with no host read between them, ported
from ``repro.engine.fused`` (DESIGN.md §8.6).

``FLConfig.fuse_rounds > 0`` runs chunks of up to that many rounds of the
compiled backend's round body,

    poll → select_mask_traced → cohort gather + train → fedavg (K1)

with the selection fully on the device: the strategy's
``select_mask_traced`` takes its randomness as tensors that the engine's
draws make.  A chunk asks for its rounds' draws at its start, in round
order (poll r, minibatch rows r, selection noise r, poll r + 1, ...),
the order the eager compiled loop asks for them, so for the strategies
that are deterministic given the losses (``fedlecc``, ``lossonly``,
``haccs``, ``fedcs``) a fused run selects what the eager compiled run
selects, round for round.  Each round's masks and cohort losses stay on
the device and are read once, at the chunk's end.

The systems and fault axes enter a chunk as the reference's exogenous
(L, K) inputs, made on the host at the chunk's start: availability and
deadline arrival, admission (the health ledger read at the chunk's start,
so a client flagged mid-chunk starts its quarantine at the next chunk, the
reference's chunk-granular lag) and the fault decisions.  Each round of
the body gates the losses, keeps the survivors ``final``, injects faults
into the arrived rows, runs the validation gate and zeroes the flagged
rows' weights, all with no host read; after the chunk the health ledger
replays the rounds' arrivals and flags.

Chunk boundaries follow the reference's ``_chunk_len``: a chunk ends at
the next ``eval_every`` round, at the configured terminal round, at the
call's last round and at the checkpointer's next round-triggered save
point, so evaluation (on the host, after the chunk) sees the parameters
the eager loop would, chunked ``rounds()`` calls equal one contiguous
call, and a save fires on committed chunk-boundary state (only a chunk's
last round may save).  A run resumed from a save point replays the same
chunk pattern.

On the card each distinct chunk length is captured once as a
``torch.cuda.CUDAGraph`` and replayed (the reference compiles each length
once): the first chunk of a length runs eagerly on a side stream — the
warm-up that capture needs, and a real chunk — and is then captured; the
later chunks of that length copy their draws into the graph's input
buffers and replay it.  A graph's K1 launch happens at replay, so the
kernel's wrapper counts it at capture (``masked_weighted_sum.captured``)
and this engine counts the replays: ``graph_launches[L]`` K1 launches a
replay of length L, ``graph_replays[L]`` replays.  If capture fails the
run raises; it never falls back to eager chunks.  On the CPU the same
body runs eagerly, chunk by chunk.

State commits per chunk.  A replay overwrites the graph's output buffers,
so ``engine.params`` is a copy of them after each chunk: a reference to
``engine.params`` taken before a ``rounds()`` call keeps its values (the
reference's donation instead invalidates such an alias).  For the same
reason a ``restore`` only rebinds ``engine.params`` (and the axes'
state): each chunk copies ``engine.params`` into its graph's input
buffer, so the graphs captured before a restore stay valid.

Memory.  Every fused engine warms up and captures on one side stream a
device (``_capture_stream``): cuBLAS keeps a workspace for each stream it
has run on (64 MiB on an H100) until its workspaces are cleared, so a
stream per engine kept 64 MiB per engine built.  ``close()`` (also reached
from ``__del__``) drops the graphs and their buffers; when no fused engine
holds a graph any more, it also returns cuBLAS's workspaces, which are
made again at the next product.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.engine.base import RoundResult
from repro_torch.engine.compiled import CompiledEngine
from repro_torch.engine.config import fused_aggregator_error, fused_strategy_error
from repro_torch.kernels.aggregate import masked_weighted_sum

__all__ = ["FusedEngine"]

_holders = 0  # fused engines that hold captured graphs


@functools.cache
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream of every fused engine's warm-ups and captures on
    ``device``."""
    return torch.cuda.Stream(device)


@dataclass
class _Graph:
    """A captured chunk: the graph, its input buffers and its outputs."""

    graph: torch.cuda.CUDAGraph
    params: torch.Tensor
    poll: torch.Tensor | None
    batch: torch.Tensor
    noise: tuple[torch.Tensor, ...]
    ext: dict[str, torch.Tensor]
    out: tuple[torch.Tensor, ...]
    quant_error: torch.Tensor | None


class FusedEngine(CompiledEngine):
    """CompiledEngine semantics, chunk by chunk (captured on the card)."""

    backend = "compiled"  # fused is an execution mode of the compiled backend

    def __init__(self, cfg, train, test, n_classes: int, *, device="cuda", draws=None,
                 partition_labels=None):
        super().__init__(cfg, train, test, n_classes, device=device, draws=draws,
                         partition_labels=partition_labels, cohort_gather=True)
        if not getattr(self.strategy, "supports_traced_selection", False):
            raise ValueError(fused_strategy_error(cfg.strategy))
        if cfg.aggregator != "fedavg":
            raise ValueError(fused_aggregator_error(cfg.aggregator))
        self._graphs: dict[int, _Graph] = {}
        self.graph_launches: dict[int, int] = {}  # K1 launches a replay, by chunk length
        self.graph_replays: dict[int, int] = {}

    def _chunk_len(self, rnd: int, end: int) -> int:
        """Rounds to fuse from absolute round ``rnd``: at most
        ``fuse_rounds``, ending at the next ``eval_every`` round, the
        configured terminal round, the call's last round ``end - 1`` or the
        checkpointer's next round-triggered save point."""
        cfg = self.cfg
        ev = cfg.eval_every
        next_eval = rnd if rnd % ev == 0 else (rnd // ev + 1) * ev
        boundary = min(next_eval, end - 1)
        if rnd <= cfg.rounds - 1:
            boundary = min(boundary, cfg.rounds - 1)
        if self.checkpointer is not None and self.checkpointer.policy.every_rounds is not None:
            n = self.checkpointer.policy.every_rounds
            boundary = min(boundary, (rnd // n + 1) * n - 1)  # min r >= rnd, (r + 1) % n == 0
        return max(1, min(cfg.fuse_rounds, boundary - rnd + 1))

    def _draw_chunk(self, rnd: int, length: int):
        """The chunk's draws, round by round, stacked on a leading round
        axis: poll rows (or None), minibatch rows, selection noise; and
        the axes' (L, K) inputs, on the host and on the device."""
        rounds = [self._draw_round(r, noise=True) for r in range(rnd, rnd + length)]
        poll = None if rounds[0]["poll"] is None else torch.stack([d["poll"] for d in rounds])
        batch = torch.stack([d["batch"] for d in rounds])
        noise = tuple(torch.stack(parts) for parts in zip(*(d["noise"] for d in rounds)))
        exts = [self._exogenous(r) for r in range(rnd, rnd + length)]
        ext = {k: np.stack([e[k] for e in exts]) for k in exts[0]}
        ext_t = {k: torch.as_tensor(v, device=self.device) for k, v in ext.items()}
        return poll, batch, noise, ext, ext_t

    def _chunk_body(self, rnd: int, length: int, params, poll, batch, noise, ext):
        """``length`` rounds on the device; returns (params, (L, K)
        dispatched masks, (L, K) survivors, (L, K) arrivals, (L, m) cohort
        losses)."""
        outs = []
        for i in range(length):
            noise_i = tuple(t[i] for t in noise)
            params, *out = self._device_round(
                rnd + i, params, None if poll is None else poll[i], batch[i],
                lambda l, n=noise_i: self.strategy.select_mask_traced(l, n),
                {k: v[i] for k, v in ext.items()})
            outs.append(out)
        return (params,) + tuple(torch.stack(parts) for parts in zip(*outs))

    def _capture(self, rnd: int, length: int, poll, batch, noise, ext):
        """Run the first chunk of ``length`` eagerly on a side stream, then
        capture the chunk body with that chunk's tensors as the graph's
        input buffers; returns the eager chunk's outputs."""
        global _holders
        side = _capture_stream(self.device)
        main = torch.cuda.current_stream(self.device)
        params = self.params.clone()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._chunk_body(rnd, length, params, poll, batch, noise, ext)
        main.wait_stream(side)
        eager_error = self._quant_error
        graph = torch.cuda.CUDAGraph()
        for gen in getattr(self.draws, "graph_generators", list)():
            graph.register_generator_state(gen)
        before = masked_weighted_sum.captured
        with torch.cuda.graph(graph, stream=side):
            static_out = self._chunk_body(rnd, length, params, poll, batch, noise, ext)
        self.graph_launches[length] = masked_weighted_sum.captured - before
        self.graph_replays.setdefault(length, 0)
        if not self._graphs:
            _holders += 1
        self._graphs[length] = _Graph(graph, params, poll, batch, noise, ext, static_out,
                                      self._quant_error)
        self._quant_error = eager_error
        return out

    def _run_chunk(self, rnd: int, length: int):
        """The chunk's outputs (``_chunk_body``'s) and its host-side axis
        inputs."""
        poll, batch, noise, ext, ext_t = self._draw_chunk(rnd, length)
        if self.device.type != "cuda":
            return self._chunk_body(rnd, length, self.params, poll, batch, noise, ext_t), ext
        g = self._graphs.get(length)
        if g is None:
            return self._capture(rnd, length, poll, batch, noise, ext_t), ext
        g.params.copy_(self.params)
        if poll is not None:
            g.poll.copy_(poll)
        g.batch.copy_(batch)
        for buf, new in zip(g.noise, noise):
            buf.copy_(new)
        for k, new in ext_t.items():
            g.ext[k].copy_(new)
        g.graph.replay()
        self.graph_replays[length] += 1
        self._quant_error = g.quant_error
        params, *outs = g.out
        return (params.clone(), *outs), ext

    def close(self) -> None:
        """Drop the captured graphs and their buffers; the last fused
        engine to do so also returns cuBLAS's workspaces (module
        docstring).  The engine captures again if it runs on."""
        global _holders
        if not self._graphs:
            return
        _capture_stream(self.device).synchronize()
        self._graphs.clear()
        _holders -= 1
        if _holders == 0:
            torch._C._cuda_clearCublasWorkspaces()

    def __del__(self):
        if getattr(self, "_graphs", None):
            self.close()

    def replayed_launches(self) -> int:
        """K1 launches made by graph replays so far."""
        return sum(self.graph_launches[n] * r for n, r in self.graph_replays.items())

    # -- the fused round loop ------------------------------------------
    def rounds(self, n_rounds: int | None = None, callback=None) -> Iterator[RoundResult]:
        """Stream one ``RoundResult`` a round, computed a chunk at a time;
        the chunk's state is committed before its first round is
        yielded."""
        if n_rounds is None:
            n_rounds = max(self.cfg.rounds - self._round, 0)
        rnd, end = self._round, self._round + n_rounds
        while rnd < end:
            length = self._chunk_len(rnd, end)
            (self.params, *outs), ext = self._run_chunk(rnd, length)
            masks, finals, arrivals, losses = (t.cpu().numpy() for t in outs)
            # evaluation-due rounds are chunk-final (_chunk_len), so each
            # evaluates the chunk's committed parameters; the health ledger
            # replays the chunk's rounds in order
            results = []
            for i in range(length):
                step = self._device_step(rnd + i, masks[i], finals[i], arrivals[i], losses[i],
                                         {k: v[i] for k, v in ext.items()})
                results.append(self._finish_round(rnd + i, step))
            rnd += length
            for i, result in enumerate(results):
                # the committed state is the chunk's end: only its last
                # round may save (``_chunk_len`` ends chunks at save points)
                self._emit(result, callback, allow_save=i == length - 1)
                yield result
