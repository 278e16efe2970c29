"""Wall-clock round simulation and deadline semantics (DESIGN.md §10).

``RoundClock`` converts a ``DeviceProfile`` plus the engine's byte
ledger into per-client round durations:

    T_i(t) = download_MB·8 / down_mbps_i
           + steps_i · jitter_i(t) / compute_speed_i
           + upload_MB·8 / up_mbps_i

``steps_i`` is the number of local SGD steps the engine actually
executes for client i (``min(tau_i, max_steps)``); ``jitter_i(t)`` is
optional mean-1 lognormal per-round noise on the compute term (thermal
throttling, background load), deterministic per (seed, round) so every
backend sees identical times.

``round_outcome`` applies the deadline policy to a dispatched cohort:

- clients that are offline at dispatch are dropped immediately (the
  server knows it cannot reach them — they cost nothing);
- reachable clients whose ``T_i(t)`` exceeds the deadline are
  *stragglers*: they trained and missed the upload — the server waits
  the full deadline for them;
- the round's simulated duration is the deadline if anyone straggled,
  else the slowest survivor's ``T_i(t)``;
- aggregation reweights the survivors: the dropped clients are zeroed
  in ``selection_weights`` (``repro_torch.core.selection``), which already
  renormalizes over the surviving mass — masks stay static-shaped, so
  the compiled/fused no-retrace guarantees hold.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.systems.profiles import JITTER_STREAM, DeviceProfile

__all__ = ["RoundClock", "RoundOutcome", "round_outcome"]


class RoundClock:
    """Simulated wall-clock per client per round."""

    def __init__(self, profile: DeviceProfile, download_mb: float,
                 upload_mb: float, steps: np.ndarray,
                 jitter_sigma: float = 0.0, seed: int = 0):
        steps = np.asarray(steps, np.float64)
        if steps.shape != (profile.n_clients,):
            raise ValueError(
                f"steps must be ({profile.n_clients},), got {steps.shape}"
            )
        self.profile = profile
        self.jitter_sigma = float(jitter_sigma)
        self.seed = int(seed) & 0xFFFF_FFFF
        # MB → Mbit: ×8 (the CommModel ledger is MB-denominated)
        self._down_s = float(download_mb) * 8.0 / profile.down_mbps
        self._up_s = float(upload_mb) * 8.0 / profile.up_mbps
        self._compute_s = steps / profile.compute_speed

    def base_times(self) -> np.ndarray:
        """(K,) jitter-free round durations — the profile-derived latency
        rank (what HACCS's latency tiebreak consumes)."""
        return self._down_s + self._compute_s + self._up_s

    def times(self, t: int) -> np.ndarray:
        """(K,) round durations at round ``t`` (compute-term jitter
        applied); deterministic per (seed, t)."""
        if self.jitter_sigma <= 0.0:
            return self.base_times()
        s = self.jitter_sigma
        rng = np.random.default_rng([self.seed, JITTER_STREAM, int(t)])
        jitter = rng.lognormal(-0.5 * s * s, s, size=self.profile.n_clients)
        return self._down_s + self._compute_s * jitter + self._up_s


@dataclass(frozen=True)
class RoundOutcome:
    """What the systems layer did to one dispatched cohort."""

    survivors: np.ndarray     # sorted client indices whose update arrived
    n_dispatched: int         # cohort size the strategy selected
    n_reached: int            # dispatched ∧ online (paid the download)
    n_dropped: int            # dispatched − survivors (offline + stragglers)
    sim_time: float           # simulated seconds this round took


def round_outcome(sel: np.ndarray, avail: np.ndarray, times: np.ndarray,
                  deadline_s: float | None) -> RoundOutcome:
    """Apply availability + deadline to the dispatched cohort ``sel``.

    ``avail``/``times`` are full (K,) vectors for the round; ``sel`` is
    the strategy's index list.  With no deadline the server waits for
    every reachable client (offline ones are dropped at dispatch)."""
    sel = np.asarray(sel, np.int64)
    reached = np.asarray(avail, bool)[sel]
    t_sel = np.asarray(times, np.float64)[sel]
    if deadline_s is None:
        arrived = reached
        straggled = np.zeros_like(reached)
    else:
        arrived = reached & (t_sel <= deadline_s)
        straggled = reached & ~arrived
    survivors = np.sort(sel[arrived])
    if straggled.any():
        sim_time = float(deadline_s)
    elif arrived.any():
        sim_time = float(t_sel[arrived].max())
    else:
        sim_time = float(deadline_s or 0.0)
    return RoundOutcome(
        survivors=survivors,
        n_dispatched=int(sel.size),
        n_reached=int(reached.sum()),
        n_dropped=int(sel.size - survivors.size),
        sim_time=sim_time,
    )
