"""CompiledEngine — the mask-gated round on the device, ported from
``repro.engine.compiled``.

Selection enters the round as a weight vector: the strategy's
``select_mask`` gives a (K,) participation mask on the device, and
``selection_weights`` turns it into FedAvg weights that are zero outside
it.  Since m is static, ``cohort_indices`` gives the cohort's (m,) client
indices with no host read; the round gathers their data and minibatch
rows (``draws.client_batch_indices``, drawn for every client, so a
client's rows do not depend on the cohort it is in), trains just those m
clients and aggregates the cohort with the cohort slice of the weights:
one launch of the FedAvg reduce kernel (K1) for ``fedavg``, ``fednova``
and ``feddyn``, the sorts for ``trimmed_mean`` and ``coordinate_median``.
``cohort_gather=False`` keeps the legacy path: every client trains and
K1 reduces the (K, P) stack with zero weights outside the mask, which is
the scaleout backend's round in a world of one.  ``make_scaleout_round``
is re-exported from ``repro_torch.engine.scaleout``.

The whole round — poll, selection, training, aggregation — is queued on
the device with no host read; the mask and the cohort's losses are read
once, at its end.  ``FusedEngine`` (``repro_torch.engine.fused``) runs
the same round body chunk after chunk.  The round's pieces are also
hooks, as the reference's compiled backend offers them to its async
runtime (``repro_torch.engine.async_engine``): ``poll_losses`` (the poll
on the device, read back), ``select`` (``MaskSelectionMixin``'s: the mask
from ``self.rng``, as ``select_mask``) and ``local_train`` (the gathered
cohort's training, ``_train_cohort``, which the round body runs too).

With the systems or fault axis, the round takes the reference's
exogenous inputs as (K,) tensors (``_exogenous``: availability, deadline
arrival, admission, the fault decisions): offline and quarantined
clients enter selection as ``-inf`` losses, the cohort is the
over-selected ``m_eff``, faults are injected into the arrived rows and
the validation gate runs on the device; dispatched clients that are
dropped or flagged keep their slot at weight exactly zero, and a round
with no survivor keeps the parameters.  The host reads the round's
masks once and does the accounting (``_device_step``: the health ledger,
the systems outcome, the ledger's bytes).

With a population the cohort's rows live in the host store, so the round
cannot stay on the device from end to end; ``_population_round_step``
splits it at the cohort: the resident members are polled from their
gathered rows and scattered into a (K,) loss vector, the resident mask
joins the admission gate, the mask is selected on the device and read
once with the cohort (and the residents' losses, for the shard
estimates); the cohort is gathered from the store, its minibatch rows
drawn for it alone (``draws.batch_indices``), and the rest of the round
— faults, the gate, ``_aggregate`` with ``selection_weights`` of the
mask — is the flat round's, so one shard gives the flat engine's bits.
``cohort_gather=False`` is refused there: no stack lives on the device.

``compress_bits > 0`` replaces fedavg with ``compressed_fedavg``
(``repro_torch.federated.compression``): the cohort's deltas are
quantized with stochastic rounding in the cohort's own buffer and
reduced with one K1 launch; ``last_quant_error`` reports the last
round's mean quantization error.

As in the reference, the strategy must have a mask selection
(``supports_compiled_selection``) and ``client_mode`` must be
``"plain"``; ``FLConfig`` rejects anything else up front and the engine
checks again.

Beyond the base's round carry, a checkpoint holds the last quantization
error (``compress_bits``); the health ledger, which each round replays
from the device's masks, is the base's.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.convert import leaf_segments
from repro_torch.core.selection import cohort_indices, selection_weights
from repro_torch.engine.base import Engine, MaskSelectionMixin, _Step
from repro_torch.engine.scaleout import make_scaleout_round  # the reference's re-export
from repro_torch.federated.client import local_train
from repro_torch.federated.compression import compressed_fedavg

__all__ = ["CompiledEngine", "make_scaleout_round"]


class CompiledEngine(MaskSelectionMixin, Engine):
    backend = "compiled"

    def __init__(self, cfg, train, test, n_classes: int, *, device="cuda", draws=None,
                 partition_labels=None, cohort_gather: bool = True):
        if cfg.population is not None and not cohort_gather:
            raise ValueError(
                "FLConfig.population keeps the client stacks host-side, so "
                "the legacy every-client-trains path (cohort_gather=False) "
                "has nothing device-resident to train on — use "
                "cohort_gather=True or set population=None"
            )
        super().__init__(cfg, train, test, n_classes, device=device, draws=draws,
                         partition_labels=partition_labels)
        self._check_mask_backend()
        self.cohort_gather = bool(cohort_gather)
        self._sizes_t = torch.as_tensor(self.sizes, dtype=torch.float32, device=self.device)
        self._taus_t = torch.as_tensor(self.taus, device=self.device)
        self._leaves = (leaf_segments(self.task.layout(train, n_classes))
                        if cfg.compress_bits else None)
        self._quant_error: torch.Tensor | None = None

    @property
    def last_quant_error(self) -> float | None:
        """Mean |dequantized − exact delta| of the last compressed round
        (None before one, and without ``compress_bits``)."""
        return None if self._quant_error is None else float(self._quant_error)

    # -- the round on the device ---------------------------------------
    def _draw_round(self, rnd: int, noise: bool = False) -> dict:
        """Round ``rnd``'s draws, in order: the poll's rows (when the
        strategy polls), every client's minibatch rows and, for a fused
        round, the strategy's selection noise."""
        cfg = self.cfg
        out = {"poll": None, "noise": ()}
        if self.strategy.needs_losses:
            out["poll"] = self.draws.poll_indices(rnd, self.sample_probs, cfg.eval_samples)
        out["batch"] = self.draws.client_batch_indices(rnd, self.sample_probs, self.max_steps,
                                                       cfg.batch_size)
        if noise:
            out["noise"] = self.draws.selection_noise(
                rnd, self.strategy.traced_noise, cfg.n_clients,
                getattr(self.strategy, "n_clusters", 0))
        return out

    def _exogenous(self, rnd: int) -> dict[str, np.ndarray]:
        """Round ``rnd``'s inputs from the axes, host-side numpy (the
        reference's fused scan inputs): availability and deadline arrival
        (systems), admission and the fault decisions ``fkind`` / ``fu``
        (faults).  Empty without an axis."""
        ext = {}
        if self._systems is not None:
            ext["avail"] = np.asarray(self._systems.available(rnd), bool)
            ext["arrived"] = np.asarray(self._systems.arrived(rnd), bool)
        if self._faults is not None:
            ext["admit"] = self._faults.health.admitted(rnd)
            ext["fkind"], ext["fu"] = self._faults.decide(rnd)
        return ext

    def _device_round(self, rnd: int, params: torch.Tensor, poll: torch.Tensor | None,
                      batch: torch.Tensor,
                      select: Callable[[torch.Tensor], torch.Tensor],
                      ext: dict[str, torch.Tensor] | None = None):
        """One round with no host read (unless ``select`` makes one):
        returns (new params, (K,) dispatched mask, (K,) survivors
        ``final``, (K,) arrivals before the gate's flags, (m_eff,) cohort
        training losses).  ``ext`` holds ``_exogenous``'s inputs as (K,)
        tensors on the device: the admission gate makes offline and
        quarantined clients ``-inf`` before selection; dispatched clients
        offline or past the deadline, quarantined or flagged by the
        validation gate keep their cohort slot at aggregation weight
        exactly zero; faults are injected into arrived rows only; a round
        with no survivor leaves the parameters (and the aggregator's
        state) as they were."""
        cfg = self.cfg
        ext = ext or {}
        if poll is not None:
            losses = self._poll(params, poll)
        else:
            losses = torch.zeros(cfg.n_clients, dtype=torch.float32, device=self.device)
        mask, final = self._gate_select(losses, select, ext)
        idx = cohort_indices(mask, self.m_eff)
        if self.cohort_gather:
            rows = idx
            stacked, train_losses = self._train_cohort(params, idx, batch)
        else:
            rows = torch.arange(cfg.n_clients, device=self.device)
            stacked, train_losses = local_train(
                self._apply_fn, self._loss_fn, params, self.xs, self.ys, batch, self._taus_t,
                lr=cfg.lr, max_steps=self.max_steps,
            )
        new, final, arrivals = self._device_tail(rnd, params, stacked, rows, idx, final, ext)
        return new, mask, final, arrivals, (train_losses if self.cohort_gather
                                            else train_losses[idx])

    def _gate_select(self, losses: torch.Tensor, select: Callable[[torch.Tensor], torch.Tensor],
                     ext: dict[str, torch.Tensor], resident: torch.Tensor | None = None):
        """The admission gate (availability, admission and, with a
        population, residency) as ``-inf`` losses, then ``select``:
        returns the (K,) dispatched mask and the (K,) clients whose update
        reaches the server (online, in time, admitted)."""
        gate = resident
        for key in ("avail", "admit"):
            if key in ext:
                gate = ext[key] if gate is None else gate & ext[key]
        if gate is not None:
            losses = torch.where(gate, losses, -torch.inf)
        mask = select(losses)
        final = mask
        if "avail" in ext:
            final = final & ext["avail"] & ext["arrived"]
        if "admit" in ext:
            final = final & ext["admit"]
        return mask, final

    def _device_tail(self, rnd: int, params: torch.Tensor, stacked: torch.Tensor,
                     rows: torch.Tensor, idx: torch.Tensor, final: torch.Tensor,
                     ext: dict[str, torch.Tensor]):
        """The round after training: faults injected into the arrived
        ``rows`` of ``stacked`` and the validation gate, then ``_aggregate``
        over the survivors; returns (new params, (K,) survivors, (K,)
        arrivals before the gate's flags)."""
        cfg = self.cfg
        arrivals = final  # the updates that reach the server, before the gate
        if self._faults is not None:
            arrived_rows = arrivals[rows]
            kind_rows = torch.where(arrived_rows, ext["fkind"][rows], -1)
            stacked = self._faults.inject(stacked, params, rows, kind_rows, ext["fu"][rows],
                                          arrived_rows)
            if self._faults.defended:
                stacked, flagged_rows, _ = self._faults.validate_traced(stacked, params,
                                                                        arrived_rows)
                flagged = torch.zeros(cfg.n_clients, dtype=torch.int32, device=self.device)
                flagged = flagged.scatter_reduce(0, rows, flagged_rows.to(torch.int32), "amax")
                final = final & (flagged == 0)
        w_full = selection_weights(final, self._sizes_t)
        any_up = final.any() if ext else None
        n_selected = final.sum() if ext else self.m_eff
        return self._aggregate(rnd, params, stacked, w_full, idx, n_selected, any_up), \
            final, arrivals

    def _train_cohort(self, params: torch.Tensor, idx: torch.Tensor, batch: torch.Tensor):
        """Local training of the gathered cohort ``idx`` (a tensor of client
        indices), its minibatch rows gathered from every client's ``batch``
        (steps, K, batch): the (len(idx), P) trained cohort and its losses."""
        return local_train(
            self._apply_fn, self._loss_fn, params, self.xs[idx], self.ys[idx], batch[:, idx],
            self._taus_t[idx], lr=self.cfg.lr, max_steps=self.max_steps,
        )

    def _train_store_cohort(self, params: torch.Tensor, d: int, sel: np.ndarray):
        """Local training of the cohort ``sel`` (host client indices) from
        draw index ``d``, its rows gathered from the population's store and
        its minibatch rows drawn for it alone."""
        xs, ys, _ = self._store.gather(sel)
        bidx = self.draws.batch_indices(d, sel, self.sample_probs[torch.as_tensor(sel)],
                                        self.max_steps, self.cfg.batch_size)
        return local_train(
            self._apply_fn, self._loss_fn, params, xs, ys, bidx,
            self._taus_t[torch.as_tensor(sel, device=self.device)], lr=self.cfg.lr,
            max_steps=self.max_steps,
        )

    # -- the round's pieces as hooks (the async runtime's dispatch; select
    # is MaskSelectionMixin's) ------------------------------------------
    def local_train(self, d: int, sel: np.ndarray):
        """The gathered cohort ``sel``'s training from draw index ``d``:
        ``((stacked,), losses)``, as the host backend's hook returns."""
        batch = self.draws.client_batch_indices(d, self.sample_probs, self.max_steps,
                                                self.cfg.batch_size)
        idx = torch.as_tensor(np.asarray(sel, np.int64), device=self.device)
        stacked, losses = self._train_cohort(self.params, idx, batch)
        return (stacked,), losses.cpu().numpy()

    def _extra_meta(self) -> dict:
        meta = super()._extra_meta()
        if self.cfg.compress_bits:
            meta["quant_error"] = self.last_quant_error
        return meta

    def _install_state(self, state: dict, meta: dict) -> None:
        super()._install_state(state, meta)
        if self.cfg.compress_bits:
            err = meta["quant_error"]
            self._quant_error = None if err is None else torch.tensor(
                err, dtype=torch.float32, device=self.device)

    def _aggregate(self, rnd: int, params: torch.Tensor, stacked: torch.Tensor,
                   w_full: torch.Tensor, idx: torch.Tensor, n_selected,
                   any_up: torch.Tensor | None = None) -> torch.Tensor:
        """The round's aggregation; with ``any_up`` (a (0-dim) bool tensor:
        did anyone's update survive?) a round without survivors keeps the
        parameters, the aggregator's state and the last quantization
        error — the all-zero weight vector would zero the parameters."""
        cfg = self.cfg

        def guard(new, old):
            return new if any_up is None or old is None else torch.where(any_up, new, old)

        if cfg.compress_bits:
            # quantization models the cohort's upload: reduce the m rows
            cohort = stacked if self.cohort_gather else stacked[idx]
            new, err = compressed_fedavg(
                cohort, params, w_full[idx],
                lambda start, stop: self.draws.quant_uniforms(rnd, cohort.shape[0], start, stop),
                self._leaves, bits=cfg.compress_bits,
            )
            self._quant_error = guard(err, self._quant_error)
            return guard(new, params)
        if self.cohort_gather:
            w, taus = w_full[idx], self._taus_t[idx]
        else:
            w, taus = w_full, self._taus_t
        taus = taus.to(torch.float32)
        new = self.aggregator.aggregate(stacked, params, w, taus, self.agg_state,
                                        n_selected=n_selected)
        state = self.aggregator.update_state(self.agg_state, stacked, params, w,
                                             n_selected=n_selected)
        self.agg_state = guard(state, self.agg_state)
        return guard(new, params)

    def _device_step(self, rnd: int, mask: np.ndarray, final: np.ndarray,
                     arrivals: np.ndarray, losses: np.ndarray, ext: dict) -> _Step:
        """The host's accounting of a device round from its (K,) masks and
        (m_eff,) cohort losses: the health ledger's record (arrivals and
        flags), the fault counts and upload fractions from the round's
        decisions, the systems outcome of the dispatched cohort (the same
        core as the host backend's), and the survivors' losses."""
        sel, surv = np.flatnonzero(mask), np.flatnonzero(final)
        sel_losses = losses[: len(sel)]  # the cohort's selected rows come first
        if not ext:
            return _Step(sel, sel, sel_losses, len(sel))
        n_reached, sim_time, n_dropped = len(sel), 0.0, 0
        uploaded, n_faulty, n_quarantined = float(len(surv)), 0, 0
        if self._faults is not None:
            arr = np.flatnonzero(arrivals)
            self._faults.health.record(rnd, arr, np.flatnonzero(arrivals & ~final))
            kind = np.where(arrivals, ext["fkind"], -1)
            n_faulty = int((kind >= 0).sum())
            n_quarantined = self._faults.health.n_quarantined(rnd)
            uploaded = float(self._faults.upload_fractions(kind[arr], ext["fu"][arr]).sum())
        if self._systems is not None:
            out = self._systems.outcome(rnd, sel)
            n_reached, sim_time, n_dropped = out.n_reached, out.sim_time, out.n_dropped
        return _Step(sel, surv, sel_losses[final[sel]], n_reached, uploaded, sim_time,
                     n_dropped, n_faulty, n_quarantined)

    def _population_round_step(self, rnd: int) -> _Step:
        """The round under a population, split at the cohort (the module
        docstring): one host read between selection and training."""
        cfg = self.cfg
        resident = torch.as_tensor(self._begin_population_round(rnd), device=self.device)
        members = self._pop_members
        ext = self._exogenous(rnd)
        ext_t = {k: torch.as_tensor(v, device=self.device) for k, v in ext.items()}
        params = self.params
        losses = torch.zeros(cfg.n_clients, dtype=torch.float32, device=self.device)
        polled = None
        if self.strategy.needs_losses:
            polled = self._poll_members(params, rnd, members)
            losses[torch.as_tensor(members, device=self.device)] = polled
        mask, final = self._gate_select(losses, lambda ls: self.select_mask(rnd, ls), ext_t,
                                        resident)
        idx = cohort_indices(mask, self.m_eff)
        sel = idx.cpu().numpy()
        if polled is not None:
            # the residents' raw losses into the shard estimates (the next
            # round's shard ranking; this round's selection is made)
            raw = np.zeros(cfg.n_clients, np.float32)
            raw[members] = polled.cpu().numpy()
            self._population.observe(raw)
        stacked, train_losses = self._train_store_cohort(params, rnd, sel)
        self.params, final, arrivals = self._device_tail(rnd, params, stacked, idx, idx, final,
                                                         ext_t)
        return self._device_step(
            rnd, *(t.cpu().numpy() for t in (mask, final, arrivals, train_losses)), ext)

    def _round_step(self, rnd: int) -> _Step:
        if self._population is not None:
            return self._population_round_step(rnd)
        d = self._draw_round(rnd)
        ext = self._exogenous(rnd)
        ext_t = {k: torch.as_tensor(v, device=self.device) for k, v in ext.items()}
        self.params, *outs = self._device_round(
            rnd, self.params, d["poll"], d["batch"], lambda losses: self.select_mask(rnd, losses),
            ext_t)
        return self._device_step(rnd, *(t.cpu().numpy() for t in outs), ext)
