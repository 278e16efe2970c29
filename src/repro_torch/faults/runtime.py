"""``FaultRuntime`` — builds the configured fault models once and owns
every engine-facing fault operation, ported from ``repro.faults.runtime``
(the reference's DESIGN.md §14).

Determinism contract (the reference's): all fault randomness comes from
the dedicated numpy child stream ``default_rng([seed, FAULT_STREAM,
round])`` with a fixed draw order (hit vector, model pick, then one
``draw_param`` vector per configured model), so the decision for (seed,
round, client) is the reference's, independent of cohort composition, and
never touches the engine's draws — ``faults=None`` and ``rate=0`` give the
same bits.

The device half — injection (``inject``: the traced models, then the
stale-replay cache) and the validation gate (``validate_traced``) — is
torch on the cohort's device with no host read, so the host backend, the
compiled round and a captured fused chunk share it.  The host backend
enters through ``process_begin`` / ``process_finish``, the compiled and
fused rounds call ``inject`` and ``validate_traced`` in their round body
and replay the health ledger afterwards.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from repro_torch.faults.defense import screen_norms, update_norms, validate_updates
from repro_torch.faults.health import ClientHealth
from repro_torch.faults.models import FAULT_STREAM, build_fault

__all__ = ["FaultRuntime", "FaultInfo"]


@dataclass(frozen=True)
class FaultInfo:
    """What one eager round's fault processing did — feeds
    ``RoundResult`` and the comm model."""

    survivors: np.ndarray  # client ids passing arrival ∩ validation
    n_faulty: int  # injected-faulty among arrivals (ground truth)
    n_quarantined: int  # clients in quarantine after this round
    uploaded: float  # Σ upload fractions over arrivals (partial bytes)


class FaultRuntime:
    """``params_template`` is the engine's flat (P,) parameter vector (its
    dtype, size and device size the stale-replay cache); ``leaves`` its
    leaf stretches (``repro_torch.convert.leaf_segments``), for the models
    that act leaf by leaf."""

    def __init__(self, cfg, *, n_clients: int, seed: int, params_template: torch.Tensor,
                 leaves=None):
        self.cfg = cfg
        self.n = int(n_clients)
        self.seed = int(cfg.seed if cfg.seed is not None else seed)
        self.models = [
            build_fault(name, **cfg.model_kwargs.get(name, {}))
            for name in cfg.models
        ]
        self.leaves = leaves
        self.defended = cfg.defended
        self.health = ClientHealth(
            n_clients,
            quarantine_rounds=cfg.quarantine_rounds,
            backoff=cfg.backoff,
            max_backoff_exp=cfg.max_backoff_exp,
            fail_threshold=cfg.fail_threshold,
        )
        self.validate_traced = partial(
            validate_updates, q=cfg.clip_quantile, tol=cfg.norm_tolerance
        )
        # stale_replay's cross-round cache: the last honest trained params
        # of each client (K, P) and a sent flag, on the device — allocated
        # only when the model is configured (48 GB at xlstm-125m's P)
        self._stale_idx = next(
            (j for j, m in enumerate(self.models) if not m.traced), None
        )
        if self._stale_idx is not None:
            self._stale_cache = torch.zeros((self.n,) + tuple(params_template.shape),
                                            dtype=params_template.dtype,
                                            device=params_template.device)
            self._stale_sent = torch.zeros(self.n, dtype=torch.bool,
                                           device=params_template.device)

    # -- per-round decisions -------------------------------------------
    def decide(self, rnd: int) -> tuple[np.ndarray, np.ndarray]:
        """(kind, u) over the whole population for round ``rnd`` —
        ``kind[c]`` is the model index injected for client ``c`` (−1 =
        honest), ``u[c]`` its scalar parameter."""
        rng = np.random.default_rng([self.seed, FAULT_STREAM, int(rnd)])
        hit = rng.random(self.n) < self.cfg.rate
        which = rng.integers(0, len(self.models), self.n)
        us = np.stack([m.draw_param(rng, self.n) for m in self.models])
        kind = np.where(hit, which, -1).astype(np.int64)
        u = us[which, np.arange(self.n)].astype(np.float32)
        return kind, u

    def upload_fractions(self, kind_rows: np.ndarray, u_rows: np.ndarray) -> np.ndarray:
        """Per-row fraction of update bytes that reach the server."""
        fr = np.ones(len(kind_rows), np.float64)
        for j, m in enumerate(self.models):
            rows = kind_rows == j
            if rows.any():
                fr[rows] = m.upload_fraction(u_rows[rows])
        return fr

    # -- injection (device tensors, no host read) ----------------------
    def apply_traced(self, stacked, fetched, kind_rows, u_rows):
        """Mix each traced model's corruption into its rows: ``kind_rows``
        (m,) int64 and ``u_rows`` (m,) float32 on the cohort's device."""
        out = stacked
        for j, m in enumerate(self.models):
            if not m.traced:
                continue
            out = torch.where((kind_rows == j)[:, None],
                              m.apply(stacked, fetched, u_rows, self.leaves), out)
        return out

    def inject(self, stacked, fetched, clients, kind_rows, u_rows, arrived):
        """``apply_traced``, then the stale-replay cache: rows of kind
        ``stale_replay`` re-send their client's last honest upload (the
        fetched params before the first), and every arrived row of
        another kind becomes its client's cache entry.  ``clients`` (m,)
        int64 is the client of each row, ``arrived`` (m,) bool the rows
        that reach the server; all on the cohort's device."""
        out = self.apply_traced(stacked, fetched, kind_rows, u_rows)
        if self._stale_idx is None:
            return out
        stale = kind_rows == self._stale_idx
        cached = self._stale_cache[clients]
        replay = torch.where(self._stale_sent[clients][:, None], cached,
                             fetched.to(stacked.dtype)[None])
        out = torch.where(stale[:, None], replay, out)
        # the cache holds the client's last *uploaded* honest params, so
        # the replay is the same whichever backend (and cohort) ran it
        fresh = arrived & ~stale
        self._stale_cache[clients] = torch.where(fresh[:, None], stacked.to(cached.dtype),
                                                 cached)
        self._stale_sent[clients] |= fresh
        return out

    def inject_eager(self, rnd: int, clients: np.ndarray, arrived: np.ndarray,
                     stacked, fetched):
        """Corrupt the rows of ``stacked`` (row i trained by client
        ``clients[i]``) per this round's decisions.  Faults are properties
        of *uploads*, so only ``arrived`` rows are touched.  Zero work on
        the cohort — and the unchanged input object — when nothing hits
        (the stale cache still takes the round's uploads)."""
        clients = np.asarray(clients, np.int64)
        arrived = np.asarray(arrived, bool)
        kind, u = self.decide(rnd)
        kind_rows = np.where(arrived, kind[clients], -1)
        u_rows = u[clients]
        if not (kind_rows >= 0).any() and self._stale_idx is None:
            return stacked, kind_rows, u_rows
        dev = stacked.device
        out = self.inject(
            stacked, fetched, torch.as_tensor(clients, device=dev),
            torch.as_tensor(kind_rows, device=dev), torch.as_tensor(u_rows, device=dev),
            torch.as_tensor(arrived, device=dev))
        return (out if (kind_rows >= 0).any() else stacked), kind_rows, u_rows

    # -- defense --------------------------------------------------------
    def entry_norms(self, stacked, fetched) -> tuple[np.ndarray, np.ndarray]:
        """Per-row (norm, finite) for the async buffer's host-side
        screening (``screen_norms``)."""
        norm, finite = update_norms(stacked, fetched)
        return norm.cpu().numpy(), finite.cpu().numpy()

    def screen_entry_norms(self, norms, finite, valid):
        return screen_norms(
            norms,
            finite,
            valid,
            q=self.cfg.clip_quantile,
            tol=self.cfg.norm_tolerance,
        )

    # -- the eager one-stop ---------------------------------------------
    def process_begin(self, rnd: int, clients: np.ndarray,
                      arrived: np.ndarray, stacked, fetched):
        """Device half of the eager round's fault work: inject and queue
        the gate without reading its verdict back.  Returns ``(new_stacked,
        pending)`` — the caller queues downstream device work (the
        optimistic aggregation) and only then resolves ``pending`` via
        :meth:`process_finish`."""
        clients = np.asarray(clients, np.int64)
        arrived = np.asarray(arrived, bool)
        out, kind_rows, u_rows = self.inject_eager(
            rnd, clients, arrived, stacked, fetched
        )
        flagged = None
        if self.defended:
            out, flagged, _ = self.validate_traced(
                out, fetched, torch.as_tensor(arrived, device=out.device)
            )
        return out, (rnd, clients, arrived, kind_rows, u_rows, flagged)

    def process_finish(self, pending) -> FaultInfo:
        """Host half: read the gate's verdict, feed the health ledger, and
        build the round's ``FaultInfo``."""
        rnd, clients, arrived, kind_rows, u_rows, flagged = pending
        flagged_rows = (
            flagged.cpu().numpy() if flagged is not None
            else np.zeros(len(arrived), bool)
        )
        flagged_rows = flagged_rows & arrived
        surv = clients[arrived & ~flagged_rows]
        self.health.record(rnd, clients[arrived], clients[flagged_rows])
        fracs = self.upload_fractions(kind_rows, u_rows)
        return FaultInfo(
            survivors=surv,
            n_faulty=int((kind_rows >= 0).sum()),
            n_quarantined=self.health.n_quarantined(rnd),
            uploaded=float(fracs[arrived].sum()),
        )

    # -- checkpoint seams -----------------------------------------------
    def meta_state(self) -> dict:
        return {"health": self.health.state_dict()}

    def load_meta_state(self, d: dict) -> None:
        self.health.load_state_dict(d["health"])

    @property
    def has_stale(self) -> bool:
        return self._stale_idx is not None

    def stale_state(self) -> dict:
        """Tensor-valued stale-replay state: the (K, P) cache and the
        ``sent`` flags as int8."""
        return {"cache": self._stale_cache, "sent": self._stale_sent.to(torch.int8)}

    def load_stale_state(self, d: dict) -> None:
        self._stale_cache = torch.as_tensor(d["cache"]).to(self._stale_cache)
        self._stale_sent = torch.as_tensor(d["sent"]).to(self._stale_sent.device).bool()
