"""The asynchronous federated runtime — FedBuff-style buffered aggregation,
ported from ``repro.engine.async_engine``.

The lock-step engines wait out every dispatched cohort (or a deadline)
before aggregating; here the server keeps a target number of clients *in
flight* and aggregates as soon as the first ``buffer_k`` uploads arrive:

- **dispatch** — whenever in-flight capacity frees up, the strategy
  selects a fresh cohort among the clients that are online, admitted and
  *not already in flight* (all three enter selection as the ``-inf`` gate);
  the cohort trains against the current params version, and its
  per-client arrival instants (``sim_clock +`` the systems axis's round
  times) go into the in-flight ledger.
- **aggregate** — each step pops the first ``buffer_k`` pending arrivals
  in ``(arrival time, client, group, slot)`` order and applies

      params ← params + Σ_i w_i · (trained_i − fetched_i)

  with ``w_i ∝ size_i · d(s_i)`` (``staleness_weights``, times the
  validation gate's clip scale under the fault axis), where ``s_i`` counts
  the aggregations since client i fetched; arrivals staler than
  ``max_staleness`` are dropped with weight exactly 0.  The kept entries'
  deltas are gathered into one (b, P) fp32 buffer, b ≤ ``buffer_k``, and
  reduced by one launch of the FedAvg reduce kernel (K1); a step that keeps
  nothing launches nothing.  The params version bumps once per step that
  applies an update.
- **event clock** — ``sim_clock`` advances to the last consumed arrival
  (monotone; ``RoundResult.sim_time`` is the step's advance).  The event
  order is host numpy in float64, a sort over at most ``concurrency``
  entries.  The systems lookups (availability, times) and the fault
  decisions stay indexed by the integer step.

Draws.  Each dispatch takes the next *draw index* (the reference's one
3-way key split a dispatch): the poll's rows and the cohort's minibatch
rows come from ``draws`` at that index, so under draws that replay the
reference's key chain the d-th dispatch sees the reference's d-th split.
The count of dispatches rides the checkpoint.

``AsyncConfig.dispatch = "sync"`` is the degenerate configuration: the
round loop is the lock-step ``Engine.rounds`` itself (draw index = round),
bit-identical to the synchronous engine by construction.

The ledger.  A group (one dispatched cohort) keeps only its *pending*
trained rows: at the end of each step the rows of served slots are
dropped, so the ledger's memory is bounded by ``concurrency`` rows, not by
the groups alive (the reference keeps each group's whole stack until its
last slot is served — the same numbers: a served row is never read
again).  The params a cohort trained against are kept once per params
version (``_fetched``): the params at a version are unique, and every
update of ``self.params`` rebinds it to a new tensor, never writing in
place, so a fetched tensor is never changed by a later aggregation.
Under a defended fault axis each group's per-slot delta norms are taken
once at dispatch, over the whole cohort, and ride the ledger.

Checkpointing: the ledger's arrays (cohort indices, arrival times,
pending flags, losses, row map, pending rows, fault slots, norms) and the
fetched params ride the checkpoint's tree; its structure (group sizes,
row counts, versions, dispatch instants) and the version and dispatch
counters ride the meta, so ``restore`` builds the ``like`` skeleton — on
the ``"meta"`` device, allocating nothing — before the arrays load.  A
run killed mid-buffer resumes bit-identically.

Comm accounting is the lock-step ``CommModel``'s, split by event:
downloads and the loss poll at dispatch, uploads when arrivals are
popped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.engine.async_config import make_staleness_discount, staleness_weights
from repro_torch.engine.base import RoundResult, _mean_loss
from repro_torch.engine.compiled import CompiledEngine
from repro_torch.engine.host import HostEngine
from repro_torch.kernels.aggregate import masked_weighted_sum

__all__ = ["AsyncHostEngine", "AsyncCompiledEngine"]

_Entry = tuple[float, int, int, int]  # (arrival_t, client, group index, slot)


@dataclass
class _InflightGroup:
    """One dispatched cohort in the in-flight ledger."""

    sel: np.ndarray         # (g,) int64 dispatched clients
    version: int            # params version the cohort trained against
    dispatch_round: int     # step index at dispatch
    dispatch_t: float       # sim_clock at dispatch
    arrival_t: np.ndarray   # (g,) float64 absolute arrival instants
    pending: np.ndarray     # (g,) bool: dispatched, not yet popped
    losses: np.ndarray      # (g,) float32 local training losses
    rows: np.ndarray        # (g,) int64: slot -> row of ``stacked`` (-1: dropped)
    stacked: torch.Tensor   # (n_rows, P) trained params of the pending slots
    # the fault axis: the injected fault per slot (-1 honest) and its
    # parameter; under a defended axis also each slot's delta norm and
    # all-finite flag, taken at dispatch
    fault_kind: np.ndarray | None = None
    fault_u: np.ndarray | None = None
    norms: np.ndarray | None = None
    finite: np.ndarray | None = None


class AsyncRounds:
    """The async round loop and its ledger checkpointing on top of a
    lock-step backend (``HostEngine`` / ``CompiledEngine``), whose hooks
    ``poll_losses`` / ``select`` / ``local_train`` it drives."""

    def __init__(self, cfg, train, test, n_classes: int, **kwargs):
        super().__init__(cfg, train, test, n_classes, **kwargs)
        acfg = cfg.async_mode
        if acfg is None:
            raise ValueError("async engines require FLConfig.async_mode to be set")
        self.async_cfg = acfg
        self._buffer_k = acfg.buffer_effective(self.m_eff)
        self._concurrency = acfg.concurrency_effective(self.m_eff)
        self._discount = make_staleness_discount(acfg.staleness, **acfg.staleness_kwargs)
        self._version = 0
        self._dispatches = 0  # the next draw index
        self._ledger: list[_InflightGroup] = []
        self._fetched: dict[int, torch.Tensor] = {}  # params by version, while a group needs them

    def rounds(self, n_rounds: int | None = None,
               callback: Callable[[RoundResult], None] | None = None) -> Iterator[RoundResult]:
        if self.async_cfg.dispatch == "sync":
            # the lock-step loop itself: bit-identical to the sync engine
            yield from super().rounds(n_rounds, callback)
            return
        yield from self._async_rounds(n_rounds, callback)

    # -- the ledger ------------------------------------------------------
    def _inflight_mask(self) -> np.ndarray:
        """(K,) bool — clients with a pending upload."""
        m = np.zeros(self.cfg.n_clients, bool)
        for g in self._ledger:
            m[g.sel[g.pending]] = True
        return m

    def _n_inflight(self) -> int:
        return sum(int(g.pending.sum()) for g in self._ledger)

    def _row(self, gi: int, si: int) -> torch.Tensor:
        g = self._ledger[gi]
        return g.stacked[int(g.rows[si])]

    def _fill_inflight(self, rnd: int) -> None:
        """Dispatch fresh cohorts until the in-flight target is met or the
        dispatchable population (online ∧ admitted ∧ idle) runs dry; each
        dispatch takes the next draw index."""
        while self._n_inflight() + self.m_eff <= self._concurrency:
            idle = ~self._inflight_mask()
            gate = self._selection_gate(rnd)
            gate = idle if gate is None else gate & idle
            if not gate.any():
                break
            d = self._dispatches
            self._dispatches += 1
            losses = self._gated_losses(rnd, self.poll_losses(d), extra_gate=idle)
            sel = np.asarray(self.select(rnd, losses))
            # strategies return m_eff indices even when supply is short;
            # busy, offline and quarantined clients are not dispatched
            sel = sel[gate[sel]]
            if sel.size == 0:
                break
            payload, sel_losses = self.local_train(d, sel)
            stacked = payload[0]
            g = _InflightGroup(
                sel=np.asarray(sel, np.int64), version=int(self._version),
                dispatch_round=int(rnd), dispatch_t=float(self.sim_clock),
                arrival_t=np.asarray(
                    self.sim_clock + np.asarray(self._systems.times(rnd), np.float64)[sel],
                    np.float64),
                pending=np.ones(sel.size, bool), losses=np.asarray(sel_losses, np.float32),
                rows=np.arange(sel.size, dtype=np.int64), stacked=stacked)
            if self._faults is not None:
                # faults are properties of uploads: corrupt at dispatch, so
                # the poisoned rows ride the ledger (and the checkpoint)
                g.stacked, g.fault_kind, g.fault_u = self._faults.inject_eager(
                    rnd, sel, np.ones(sel.size, bool), stacked, self.params)
                if self._faults.defended:
                    g.norms, g.finite = self._faults.entry_norms(g.stacked, self.params)
            self._fetched.setdefault(self._version, self.params)
            self._ledger.append(g)
            # downloads and the loss poll are paid at dispatch, uploads at pop
            self.comm_mb += self.comm.round_mb(int(sel.size), self.strategy.needs_losses,
                                               m_uploaded=0)
            if sel.size < self.m_eff:
                break  # a partial cohort: the idle population is exhausted

    def _pending_entries(self) -> list[_Entry]:
        """Every pending arrival, in event order."""
        entries = [(float(g.arrival_t[si]), int(g.sel[si]), gi, int(si))
                   for gi, g in enumerate(self._ledger) for si in np.flatnonzero(g.pending)]
        entries.sort()
        return entries

    def _pop_buffer_validated(self, rnd: int):
        """The fault axis's pop: pending arrivals in event order, ``buffer_k``
        at a time, each batch screened jointly by the robust-quantile norm
        gate.  A flagged arrival is *consumed* — pending cleared, its upload
        billed, its health strike recorded — but never fills a buffer slot.
        Returns ``(take, scales, consumed, n_faulty)``."""
        fr = self._faults
        entries = self._pending_entries()
        take: list[_Entry] = []
        scales: list[float] = []
        consumed: list[_Entry] = []
        flagged_clients: list[int] = []
        pos = 0
        while len(take) < self._buffer_k and pos < len(entries):
            batch = entries[pos: pos + (self._buffer_k - len(take))]
            pos += len(batch)
            consumed.extend(batch)
            if fr.defended:
                norms = np.array([self._ledger[gi].norms[si] for (_t, _c, gi, si) in batch])
                finite = np.array([self._ledger[gi].finite[si] for (_t, _c, gi, si) in batch])
                flagged, sc, _thr = fr.screen_entry_norms(norms, finite,
                                                          np.ones(len(batch), bool))
            else:
                flagged, sc = np.zeros(len(batch), bool), np.ones(len(batch))
            for e, f, s in zip(batch, flagged, sc):
                if f:
                    flagged_clients.append(e[1])
                    self._ledger[e[2]].pending[e[3]] = False
                else:
                    take.append(e)
                    scales.append(float(s))
        kind = np.array([int(self._ledger[gi].fault_kind[si]) for (_t, _c, gi, si) in consumed],
                        np.int64)
        u = np.array([float(self._ledger[gi].fault_u[si]) for (_t, _c, gi, si) in consumed],
                     np.float32)
        self.comm_mb += self.comm.round_mb(0, False,
                                           m_uploaded=float(fr.upload_fractions(kind, u).sum()))
        fr.health.record(rnd, np.array([c for (_t, c, _gi, _si) in consumed], np.int64),
                         np.array(flagged_clients, np.int64))
        return take, scales, consumed, int((kind >= 0).sum())

    def _aggregate_buffer(self, take: list[_Entry], scales=None):
        """The staleness-weighted delta rule over the popped arrivals, one
        K1 launch over the kept entries' (b, P) deltas.  Returns
        ``(aggregated clients, mean loss, n_dropped, mean staleness)``;
        bumps ``_version`` iff an update applied."""
        clients = np.array([c for (_t, c, _gi, _si) in take], np.int64)
        stal = np.array([self._version - self._ledger[gi].version for (_t, _c, gi, _si) in take],
                        np.int64)
        w = staleness_weights(self.sizes[clients], stal, self._discount,
                              self.async_cfg.max_staleness)
        if scales is not None:
            # the gate's norm clip: scaling a delta by s is scaling its weight
            w = w * np.asarray(scales, w.dtype)
        kept = w > 0.0
        if self._faults is None:
            # stale uploads still arrived: the ledger pays them either way
            self.comm_mb += self.comm.round_mb(0, False, m_uploaded=len(take))
        if kept.any():
            entries = [e for e, k in zip(take, kept) if k]
            deltas = torch.empty((len(entries), self.n_params), dtype=torch.float32,
                                 device=self.device)
            for j, (_t, _c, gi, si) in enumerate(entries):
                torch.sub(self._row(gi, si), self._fetched[self._ledger[gi].version],
                          out=deltas[j])
            wt = torch.as_tensor(w[kept], dtype=torch.float32, device=self.device)
            # rebinds, never in place: the fetched tensors of older versions
            # stay as they were
            self.params = self.params + masked_weighted_sum(deltas, wt)
            del deltas
            self._version += 1
        for (_t, _c, gi, si) in take:
            self._ledger[gi].pending[si] = False
        losses = np.array([self._ledger[gi].losses[si] for (_t, _c, gi, si) in take], np.float32)
        mean_stal = float(stal[kept].mean()) if kept.any() else 0.0
        return np.sort(clients[kept]), _mean_loss(losses[kept]), int((~kept).sum()), mean_stal

    def _prune_ledger(self) -> None:
        """Drop exhausted groups, the served rows of the others, and the
        fetched params no group needs any more."""
        live = []
        for g in self._ledger:
            if not g.pending.any():
                continue
            keep = np.flatnonzero(g.pending)
            if keep.size < g.stacked.shape[0]:
                g.stacked = g.stacked[torch.as_tensor(g.rows[keep], device=g.stacked.device)]
                g.rows = np.full(g.sel.size, -1, np.int64)
                g.rows[keep] = np.arange(keep.size)
            live.append(g)
        self._ledger = live
        versions = {g.version for g in live}
        self._fetched = {v: t for v, t in self._fetched.items() if v in versions}

    def _async_rounds(self, n_rounds: int | None,
                      callback: Callable[[RoundResult], None] | None) -> Iterator[RoundResult]:
        cfg = self.cfg
        if n_rounds is None:
            n_rounds = max(cfg.rounds - self._round, 0)
        start = self._round
        for rnd in range(start, start + n_rounds):
            self._fill_inflight(rnd)
            n_faulty = 0
            if self._faults is not None:
                take, scales, consumed, n_faulty = self._pop_buffer_validated(rnd)
            else:
                take = self._pending_entries()[: self._buffer_k]
                scales, consumed = None, take
            sim_time = 0.0
            if consumed:
                # the event clock jumps to the last consumed arrival (a
                # flagged arrival costs the server its wait time too)
                t_agg = max(self.sim_clock, consumed[-1][0])
                sim_time = t_agg - self.sim_clock
                self.sim_clock = t_agg
            if take:
                surv, mean_loss, n_dropped, mean_stal = self._aggregate_buffer(take, scales)
            else:
                # nobody aggregatable this step: the model stands still
                surv, mean_loss, n_dropped, mean_stal = np.zeros(0, np.int64), float("nan"), 0, 0.0
            self._prune_ledger()

            test_loss = test_acc = metrics = None
            if rnd % cfg.eval_every == 0 or rnd == cfg.rounds - 1:
                test_loss, test_acc = self.evaluate()
                metrics = self.eval_metrics()
            self._round = rnd + 1
            result = RoundResult(
                round=rnd,
                selected=tuple(int(i) for i in surv),
                mean_selected_loss=mean_loss,
                comm_mb=float(self.comm_mb),
                test_loss=test_loss,
                test_acc=test_acc,
                sim_time=float(sim_time),
                sim_clock=float(self.sim_clock),
                n_dropped=int(n_dropped),
                metrics=metrics,
                staleness=float(mean_stal),
                params_version=int(self._version),
                n_faulty=int(n_faulty),
                n_quarantined=(self._faults.health.n_quarantined(rnd)
                               if self._faults is not None else 0),
            )
            self._emit(result, callback)
            yield result

    # -- checkpointing ---------------------------------------------------
    def _current_version(self) -> int:
        """The params version: under ``dispatch="sync"`` every round
        aggregates, so it is the round count."""
        return self._round if self.async_cfg.dispatch == "sync" else self._version

    def _group_arrays(self, g: _InflightGroup) -> dict:
        arrs = {"sel": g.sel, "arrival_t": g.arrival_t, "pending": g.pending,
                "losses": g.losses, "rows": g.rows, "stacked": g.stacked}
        if self._faults is not None:
            arrs |= {"fault_kind": g.fault_kind, "fault_u": g.fault_u}
            if self._faults.defended:
                arrs |= {"norms": g.norms, "finite": g.finite}
        return arrs

    def _state_pytree(self) -> dict:
        state = super()._state_pytree()
        state["async_groups"] = [self._group_arrays(g) for g in self._ledger]
        state["async_fetched"] = [self._fetched[v] for v in sorted(self._fetched)]
        return state

    def _extra_meta(self) -> dict:
        meta = super()._extra_meta()
        meta["async"] = {
            "version": int(self._current_version()),
            "dispatches": int(self._dispatches),
            "fetched_versions": sorted(int(v) for v in self._fetched),
            "groups": [{"version": int(g.version), "dispatch_round": int(g.dispatch_round),
                        "dispatch_t": float(g.dispatch_t), "n": int(g.sel.size),
                        "n_rows": int(g.stacked.shape[0])} for g in self._ledger],
        }
        return meta

    def _skeleton(self, info: dict) -> _InflightGroup:
        """An empty group with the checkpointed structure: the restore's
        ``like`` (tensors on the ``"meta"`` device, so nothing is
        allocated before the arrays load)."""
        n = int(info["n"])
        g = _InflightGroup(
            sel=np.zeros(n, np.int64), version=int(info["version"]),
            dispatch_round=int(info["dispatch_round"]), dispatch_t=float(info["dispatch_t"]),
            arrival_t=np.zeros(n, np.float64), pending=np.zeros(n, bool),
            losses=np.zeros(n, np.float32), rows=np.zeros(n, np.int64),
            stacked=torch.empty((int(info["n_rows"]), self.n_params), dtype=self.params.dtype,
                                device="meta"))
        if self._faults is not None:
            g.fault_kind, g.fault_u = np.zeros(n, np.int64), np.zeros(n, np.float32)
            if self._faults.defended:
                g.norms, g.finite = np.zeros(n, np.float32), np.zeros(n, bool)
        return g

    def restore(self, path: str) -> dict:
        from repro_torch.checkpoint.serializer import load_meta

        info = load_meta(path).get("async")
        if info is None:
            raise ValueError(
                f"checkpoint {path!r} carries no async ledger meta — it was not written by an "
                f"async engine; rebuild without FLConfig.async_mode to resume it")
        # the skeleton exists before the base restore builds its ``like``
        self._ledger = [self._skeleton(g) for g in info["groups"]]
        self._fetched = {int(v): torch.empty(self.n_params, dtype=self.params.dtype,
                                             device="meta")
                         for v in info["fetched_versions"]}
        return super().restore(path)

    def _install_state(self, state: dict, meta: dict) -> None:
        super()._install_state(state, meta)
        info = meta["async"]
        self._version = int(info["version"])
        self._dispatches = int(info["dispatches"])
        for g, arrs in zip(self._ledger, state["async_groups"]):
            for name, value in arrs.items():
                setattr(g, name, value)
        self._fetched = dict(zip(sorted(self._fetched), state["async_fetched"]))


class AsyncHostEngine(AsyncRounds, HostEngine):
    """The async runtime over the host backend's hooks."""


class AsyncCompiledEngine(AsyncRounds, CompiledEngine):
    """The async runtime over the compiled backend's hooks: the poll on
    the device, the mask selection from ``self.rng``, and the gathered
    cohort's training (dispatched cohorts vary in size)."""

    def __init__(self, cfg, train, test, n_classes: int, *, cohort_gather: bool = True,
                 **kwargs):
        if not cohort_gather:
            raise ValueError(
                "the async runtime trains dispatched cohorts through the gathered path; "
                "cohort_gather=False is not supported with FLConfig.async_mode")
        super().__init__(cfg, train, test, n_classes, cohort_gather=True, **kwargs)
