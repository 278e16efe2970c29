"""``SystemsRuntime`` — the per-engine systems state the round loop
consults (DESIGN.md §10).

Built once in ``Engine.__init__`` from the validated ``SystemsConfig``
plus the engine-derived quantities (executed local steps per client,
model payload bytes, the experiment seed).  The round loop asks it
three things:

- ``available(t)``   — the (K,) availability mask at round ``t``
                       (gates the loss vector to ``-inf`` before every
                       selection call, on every backend);
- ``times(t)``       — the (K,) simulated per-client round durations;
- ``outcome(t, sel)`` / ``outcome_from_mask(t, mask)`` — the deadline
                       policy applied to the dispatched cohort: the
                       surviving participants, the drop count, and the
                       round's simulated duration.  The index and mask
                       entry points share one core, so the eager
                       backends and the fused chunk unpacker account
                       rounds identically.

Everything is deterministic per (seed, round): host, compiled,
scaleout, and fused runs of one config see bit-identical availability
traces and round times.
"""

from __future__ import annotations

import numpy as np

from repro_torch.systems.clock import RoundClock, RoundOutcome, round_outcome
from repro_torch.systems.config import SystemsConfig
from repro_torch.systems.profiles import make_availability, make_profile

__all__ = ["SystemsRuntime"]

_MB = 1024.0 * 1024.0


class SystemsRuntime:
    def __init__(self, cfg: SystemsConfig, *, n_clients: int,
                 steps: np.ndarray, n_params: int,
                 download_bytes_per_param: float = 4.0,
                 upload_bytes_per_param: float = 4.0, seed: int = 0):
        self.cfg = cfg
        self.profile = make_profile(
            cfg.profile, n_clients, seed=seed, **cfg.profile_kwargs
        )
        self.availability = make_availability(
            cfg.availability, n_clients, seed=seed, **cfg.availability_kwargs
        )
        self.clock = RoundClock(
            self.profile,
            download_mb=n_params * download_bytes_per_param / _MB,
            upload_mb=n_params * upload_bytes_per_param / _MB,
            steps=steps,
            jitter_sigma=cfg.jitter_sigma,
            seed=seed,
        )
        # Battery ledger: per-client remaining charge in
        # mAh, spent by spend_energy() after each dispatch.  None when
        # tracking is off — every path below stays bit-identical then.
        self._steps = np.asarray(steps)
        self.tracks_energy = bool(cfg.track_energy)
        self.battery_mah: np.ndarray | None = (
            np.asarray(self.profile.battery_mah, np.float64).copy()
            if self.tracks_energy else None
        )
        self.energy_total_mah = 0.0

    # ------------------------------------------------------------------
    def available(self, t: int) -> np.ndarray:
        """(K,) bool online states at round ``t`` — the availability
        trace, AND a non-drained battery when energy tracking is on (a
        depleted client is unavailable through the same admission gate)."""
        mask = self.availability.mask(t)
        if self.battery_mah is not None:
            mask = mask & (self.battery_mah > 0.0)
        return mask

    def times(self, t: int) -> np.ndarray:
        """(K,) simulated per-client round durations at round ``t``."""
        return self.clock.times(t)

    def arrived(self, t: int) -> np.ndarray:
        """(K,) bool — would a client's update beat the deadline this
        round?  All-true when no deadline is set.  (The fused backend
        feeds whole chunks of this into its round chunks.)"""
        if self.cfg.deadline_s is None:
            return np.ones(self.profile.n_clients, bool)
        return self.times(t) <= self.cfg.deadline_s

    def latency_hint(self) -> np.ndarray:
        """(K,) expected round seconds — the profile-derived latency
        handed to latency-aware strategies (HACCS) at setup."""
        return self.clock.base_times()

    # ------------------------------------------------------------------
    def outcome(self, t: int, sel: np.ndarray) -> RoundOutcome:
        """Deadline/availability outcome for the dispatched index list."""
        return round_outcome(
            sel, self.available(t), self.times(t), self.cfg.deadline_s
        )

    def outcome_from_mask(self, t: int, sel_mask: np.ndarray) -> RoundOutcome:
        """Same, from a (K,) participation mask (a fused chunk output)."""
        return self.outcome(t, np.where(np.asarray(sel_mask, bool))[0])

    # -- energy ledger -----------------------------------
    def spend_energy(self, t: int, dispatched: np.ndarray) -> dict:
        """Charge the round's dispatched-and-online clients their local
        training energy (``steps · energy_per_step`` mAh, clipped at
        empty) and return the round's energy metrics.  Spend is gated on
        the *pre-spend* availability — a client that went offline (or
        was already drained) before dispatch never ran its steps."""
        assert self.battery_mah is not None, "spend_energy without track_energy"
        sel = np.asarray(dispatched, np.int64)
        online = self.available(t)
        spenders = sel[online[sel]]
        draw = (
            self._steps[spenders]
            * np.asarray(self.profile.energy_per_step)[spenders]
        )
        spent = float(
            np.minimum(draw, self.battery_mah[spenders]).sum()
        )
        self.battery_mah[spenders] = np.maximum(
            self.battery_mah[spenders] - draw, 0.0
        )
        self.energy_total_mah += spent
        return {
            "energy_mah": spent,
            "energy_total_mah": float(self.energy_total_mah),
            "n_depleted": int((self.battery_mah <= 0.0).sum()),
        }

    # -- checkpoint contract (DESIGN.md §12) ---------------------------
    def state_dict(self) -> dict:
        """The runtime's checkpoint carry — **empty by contract**.

        This is not an omission: every systems quantity is a pure
        function of ``(seed, round)``, *including* the markov
        availability chain, which looks stateful (each round's on/off
        mask depends on the previous one) but is materialized lazily
        from its own seeded stream — ``MarkovAvailability.mask(t)``
        extends the trace from the last cached round to ``t``, and any
        prefix recomputed from scratch is bit-identical.  A freshly
        constructed runtime therefore reproduces the exact trace of the
        killed run with no carried state.

        Two things keep this sound, and both are load-bearing for the
        async runtime (DESIGN.md §13):

        - availability/time streams are indexed by the **integer
          aggregation-step index** ``t``, never by ``sim_clock`` — the
          async event clock advances ``sim_clock`` to non-integer
          arrival instants, but systems lookups stay on the step grid,
          so a resumed run re-derives the same masks/times
          (``tests/test_systems.py`` pins a resumed markov trace
          against the contiguous one);
        - the one accumulated scalar, ``engine.sim_clock``, is
          checkpointed by the engine itself in its meta.

        The hooks exist so a *genuinely* stateful runtime slots into the
        same save path — and the energy ledger is exactly
        that: battery charge accumulates across rounds as a function of
        the selection history, so with ``track_energy`` on, the carry
        holds the per-client remaining mAh and the cumulative spend.
        With it off the contract above is unchanged (still ``{}``).
        """
        if self.battery_mah is None:
            return {}
        return {
            "battery_mah": [float(b) for b in self.battery_mah],
            "energy_total_mah": float(self.energy_total_mah),
        }

    def load_state_dict(self, state: dict) -> None:
        if self.battery_mah is not None:
            batt = state.get("battery_mah")
            if batt is None or len(batt) != self.battery_mah.shape[0]:
                raise ValueError(
                    f"energy-tracking run but the checkpoint carries "
                    f"{None if batt is None else len(batt)} battery "
                    f"entries, expected {self.battery_mah.shape[0]}"
                )
            self.battery_mah = np.asarray(batt, np.float64)
            self.energy_total_mah = float(state.get("energy_total_mah", 0.0))
            extra = set(state) - {"battery_mah", "energy_total_mah"}
            if extra:
                raise ValueError(
                    f"unknown systems checkpoint keys {sorted(extra)}"
                )
            return
        if state:
            raise ValueError(
                f"SystemsRuntime carries no state for this config but the "
                f"checkpoint has systems state keys {sorted(state)}"
            )
