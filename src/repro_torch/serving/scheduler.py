"""Bucketed batch scheduler for the serving path, ported from
``repro.serving.scheduler``.

Requests are queued by exact prompt length, so every sequence of a group
shares its positions, which is what ``decode_step``'s scalar ``pos``
wants.  Groups take the largest bucket first; an underfull group is
padded with zero rows, whose tokens are dropped from the results.
Greedy decoding (``argmax``, the first index of a tie, as ``jnp.argmax``)
with an optional EOS: a group stops early once every real row has
emitted it, and each result is cut after its first EOS.

Usage:
    sched = BatchScheduler(cfg, params, max_batch=8, max_new=32)
    ids = [sched.submit(prompt) for prompt in prompts]
    sched.run()                       # drains the queue
    out = sched.result(ids[0])        # np.ndarray of generated tokens

On a grid (``mesh``: a ``launch.mesh.Mesh`` with ``data`` or ``model``
larger than 1) the families of ``models.transformer.shards_storage`` take
``params`` as this rank's blocks (``transformer.param_blocks``), as the
reference's scheduler takes them laid out by its policy: every rank
submits the same requests, and each group's rows go over the data axes
(pod and data) where they divide them (``transformer.batch_rows``), else
every rank holds every row, on its ``model`` blocks, and its block of the
k / v cache's sequence where the data axes divide the group's cache of
prompt length + ``max_new`` positions (``transformer.seq_block``, as the
reference's decode lays out a batch of one or one they do not divide):
choosing ``max_new`` so that they divide it is how a caller gets that
split for a single request or an odd group.  Prefill and decode run on
the rank's blocks and its cache block, their logits come back
replicated, and every rank makes the same tokens.  The MoE and MLA models
do so too, an MoE layer by the capacity rule the reference's dispatch takes
under its mesh (``transformer._moe_blocks``).

The model runs on the device of ``params`` (from ``init_params`` or a
checkpoint); tokens cross to it once a group and come back once a step,
which synchronises with the device.  ``groups`` records each group's
prompt length, rows, prefill seconds (to the first token on the host)
and decode steps and seconds (host clock; each step ends in that copy).
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.transformer import (
    batch_rows,
    check_supported,
    decode_step,
    prefill,
    shards_storage,
)

__all__ = ["Request", "BatchScheduler"]


@dataclass
class Request:
    rid: int
    tokens: np.ndarray          # (prompt_len,) int32
    max_new: int
    done: bool = False
    output: np.ndarray | None = None


class BatchScheduler:
    def __init__(self, cfg, params, max_batch: int = 8, max_new: int = 32,
                 eos_id: int | None = None, mesh=None):
        if cfg.input_mode != "tokens":
            raise ValueError("BatchScheduler serves token-input archs")
        check_supported(cfg, tree=True)
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.max_batch = max_batch
        self.max_new = max_new
        self.eos_id = eos_id
        self.mesh = mesh
        self._sharded = shards_storage(cfg, mesh)
        self._queue: dict[int, list[Request]] = defaultdict(list)  # by prompt len
        self._results: dict[int, Request] = {}
        self._next_id = 0
        self.groups: list[dict] = []

    # ------------------------------------------------------------------
    def submit(self, tokens: np.ndarray, max_new: int | None = None) -> int:
        rid = self._next_id
        self._next_id += 1
        req = Request(rid, np.asarray(tokens, np.int32), max_new or self.max_new)
        self._queue[len(req.tokens)].append(req)
        self._results[rid] = req
        return rid

    def pending(self) -> int:
        return sum(len(v) for v in self._queue.values())

    def result(self, rid: int) -> np.ndarray:
        req = self._results[rid]
        if not req.done:
            raise RuntimeError(f"request {rid} not finished; call run()")
        return req.output

    # ------------------------------------------------------------------
    def _next_group(self) -> list[Request] | None:
        if not self._queue:
            return None
        # largest bucket first: best slot utilization
        plen = max(self._queue, key=lambda k: len(self._queue[k]))
        bucket = self._queue[plen]
        group = bucket[: self.max_batch]
        self._queue[plen] = bucket[self.max_batch:]
        if not self._queue[plen]:
            del self._queue[plen]
        return group

    def run(self) -> int:
        """Drain the queue; returns the number of completed requests."""
        completed = 0
        while (group := self._next_group()) is not None:
            completed += self._run_group(group)
        return completed

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)

    def _run_group(self, group: list[Request]) -> int:
        plen = len(group[0].tokens)
        gmax = max(r.max_new for r in group)
        b = self.max_batch
        toks = np.zeros((b, plen), np.int32)
        for i, r in enumerate(group):
            toks[i] = r.tokens
        t0 = time.perf_counter()
        if self._sharded:       # this rank's rows of the group
            lo, n = batch_rows(self.mesh, b)
            toks = toks[lo:lo + n]
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        logits, cache = prefill(self.params, self.cfg, batch, plen + gmax, mesh=self.mesh,
                                batch_size=b)
        tok = self._greedy(logits)
        outs = [tok.cpu().numpy()]
        t1 = time.perf_counter()
        alive = np.ones(b, bool)
        for i in range(gmax - 1):
            if self.eos_id is not None:
                alive &= outs[-1][:, 0] != self.eos_id
                if not alive[: len(group)].any():
                    break
            logits, cache = decode_step(self.params, self.cfg, {"token": tok}, cache, plen + i,
                                        mesh=self.mesh, max_len=plen + gmax)
            tok = self._greedy(logits)
            outs.append(tok.cpu().numpy())
        self.groups.append({"prompt_len": plen, "rows": len(group), "prefill_s": t1 - t0,
                            "decode_steps": len(outs) - 1,
                            "decode_s": time.perf_counter() - t1})
        gen = np.concatenate(outs, axis=1)            # (b, <= gmax)
        for i, r in enumerate(group):
            seq = gen[i, : r.max_new]
            if self.eos_id is not None:
                stop = np.flatnonzero(seq == self.eos_id)
                if stop.size:
                    seq = seq[: stop[0] + 1]
            r.output = seq
            r.done = True
        return len(group)
