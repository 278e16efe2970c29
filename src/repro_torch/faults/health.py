"""``ClientHealth`` — the per-client fault ledger, ported from
``repro.faults.health`` (the reference's DESIGN.md §14.3); numpy, so its
quarantines are the reference's for the same arrivals and flags.

The server cannot see *why* a client failed validation, only that it
did; the ledger turns repeated failures into temporary exclusion with
exponential backoff:

- each validation failure bumps the client's ``consecutive`` count;
- at ``fail_threshold`` consecutive failures the client is quarantined
  for ``quarantine_rounds · backoff**strikes`` rounds (strikes capped at
  ``max_backoff_exp``) and the counter resets;
- a clean arrival resets ``consecutive`` (but not ``strikes`` — a
  historically flaky client re-offending is quarantined longer).

``admitted(t)`` feeds selection as a ``-inf`` gate alongside
availability; the whole state rides the checkpoint through
``state_dict``/``load_state_dict`` so kill-and-resume mid-quarantine is
bit-identical.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ClientHealth"]


class ClientHealth:
    def __init__(
        self,
        n_clients: int,
        *,
        quarantine_rounds: int = 2,
        backoff: float = 2.0,
        max_backoff_exp: int = 6,
        fail_threshold: int = 1,
    ):
        self.n = int(n_clients)
        self.quarantine_rounds = int(quarantine_rounds)
        self.backoff = float(backoff)
        self.max_backoff_exp = int(max_backoff_exp)
        self.fail_threshold = int(fail_threshold)
        self.consecutive = np.zeros(self.n, np.int64)
        self.strikes = np.zeros(self.n, np.int64)
        self.quarantined_until = np.zeros(self.n, np.int64)
        self.total_faults = np.zeros(self.n, np.int64)

    # -- queries --------------------------------------------------------
    def admitted(self, t: int) -> np.ndarray:
        """(K,) bool — clients allowed to participate in round ``t``."""
        return self.quarantined_until <= t

    def n_quarantined(self, t: int) -> int:
        """Clients still serving a quarantine after round ``t``."""
        return int((self.quarantined_until > t).sum())

    # -- updates --------------------------------------------------------
    def record(self, t: int, arrivals, flagged) -> None:
        """Fold one round's validation outcome into the ledger.

        ``arrivals`` — client ids whose updates reached the server this
        round; ``flagged`` — the subset that failed validation.
        """
        arrivals = np.asarray(arrivals, np.int64).reshape(-1)
        flagged = np.asarray(flagged, np.int64).reshape(-1)
        clean = np.setdiff1d(arrivals, flagged)
        self.consecutive[clean] = 0
        if len(flagged) == 0:
            return
        self.consecutive[flagged] += 1
        self.total_faults[flagged] += 1
        if self.quarantine_rounds <= 0:
            return
        trip = flagged[self.consecutive[flagged] >= self.fail_threshold]
        if len(trip) == 0:
            return
        exp = np.minimum(self.strikes[trip], self.max_backoff_exp)
        dur = np.rint(self.quarantine_rounds * self.backoff**exp).astype(np.int64)
        self.quarantined_until[trip] = t + 1 + np.maximum(dur, 1)
        self.strikes[trip] += 1
        self.consecutive[trip] = 0

    # -- checkpoint seam ------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "consecutive": self.consecutive.tolist(),
            "strikes": self.strikes.tolist(),
            "quarantined_until": self.quarantined_until.tolist(),
            "total_faults": self.total_faults.tolist(),
        }

    def load_state_dict(self, d: dict) -> None:
        for name in ("consecutive", "strikes", "quarantined_until", "total_faults"):
            arr = np.asarray(d[name], np.int64)
            if arr.shape != (self.n,):
                raise ValueError(
                    f"ClientHealth.{name}: checkpoint has shape {arr.shape}, "
                    f"engine has {self.n} clients"
                )
            setattr(self, name, arr)
