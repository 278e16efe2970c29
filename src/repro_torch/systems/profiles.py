"""Device profiles and availability traces (DESIGN.md §10).

A ``DeviceProfile`` is the static per-client hardware description the
``RoundClock`` converts into simulated wall-clock time: local-training
speed in SGD steps per second, and up/down link bandwidth in Mbit/s.
Profiles are built by registered generator presets —

- ``uniform``       — every device identical (the sanity baseline: the
                      round clock is deterministic and deadline-free
                      runs match the frictionless engine round for
                      round).
- ``zipf_compute``  — compute speed follows a Zipf law over a random
                      device ranking (a heavy straggler tail on one
                      axis), uniform bandwidth.
- ``mobile_mix``    — a three-tier phone fleet (high/mid/low-end) with
                      per-device lognormal scatter on both compute and
                      bandwidth; the cross-device regime the FedLECC
                      premise ("strict communication and participation
                      constraints") describes.

Availability is a *trace*: ``AvailabilityModel.mask(t)`` returns the
(K,) on/off state of the fleet at round ``t``, deterministic per
``(seed, t)`` so the host, compiled, scaleout, and fused backends all
consume the identical trace (the fused backend feeds whole chunks of it
into its round chunks as input tensors).  Presets:

- ``always``     — everyone online (the default).
- ``bernoulli``  — i.i.d. per round: client i is online w.p. ``p``.
- ``markov``     — per-client two-state chain: on→off w.p. ``p_drop``,
                   off→on w.p. ``p_join``; round-0 states drawn from
                   the stationary distribution.
- ``trace``      — replay a recorded on/off schedule from a CSV or JSON
                   file: fully deterministic, no rng at
                   all — the seed is ignored.  ``examples/
                   availability_trace.csv`` is a ready-made schedule.

All randomness derives from ``np.random.default_rng`` seeded on a
dedicated child stream of the engine seed — the engine's own selection
rng is never consumed, so enabling a profile does not perturb
selection sequences.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

__all__ = [
    "DeviceProfile",
    "AvailabilityModel",
    "PROFILE_PRESETS",
    "AVAILABILITY_PRESETS",
    "register_profile",
    "register_availability",
    "make_profile",
    "make_availability",
    "list_profiles",
    "list_availability_models",
]

# Child-stream tags: profiles / availability / jitter each ride their own
# rng derived as default_rng([seed, TAG]) so the traces are independent
# of each other and of every PRNG stream the engine already owns.
PROFILE_STREAM = 0x5E3D_0001
AVAILABILITY_STREAM = 0x5E3D_0002
JITTER_STREAM = 0x5E3D_0003


# Per-tier energy defaults: mAh drawn per local SGD step,
# and battery capacity in mAh — flagship tiers are both more efficient
# per step and carry bigger batteries.  Tiers beyond the table clamp to
# the last row.
_TIER_ENERGY_PER_STEP = (0.010, 0.015, 0.025, 0.040)
_TIER_BATTERY_MAH = (4500.0, 4000.0, 3000.0, 2200.0)


@dataclass(frozen=True)
class DeviceProfile:
    """Static per-client hardware description (all arrays (K,)).

    ``energy_per_step`` / ``battery_mah`` default to
    tier-derived values (``_TIER_ENERGY_PER_STEP`` / ``_TIER_BATTERY_MAH``)
    when a preset leaves them ``None`` — so every existing preset gains
    an energy model without changing its signature.  They are inert
    until ``SystemsConfig.track_energy`` turns the battery ledger on.
    """

    compute_speed: np.ndarray   # local SGD steps per simulated second
    down_mbps: np.ndarray       # server → client link, Mbit/s
    up_mbps: np.ndarray         # client → server link, Mbit/s
    tier: np.ndarray            # int device class, 0 = fastest tier
    energy_per_step: np.ndarray | None = None  # mAh per local SGD step
    battery_mah: np.ndarray | None = None      # battery capacity, mAh

    def __post_init__(self) -> None:
        k = self.compute_speed.shape[0]
        if self.energy_per_step is None:
            idx = np.clip(self.tier, 0, len(_TIER_ENERGY_PER_STEP) - 1)
            object.__setattr__(
                self, "energy_per_step",
                np.asarray(_TIER_ENERGY_PER_STEP)[idx].astype(np.float64),
            )
        if self.battery_mah is None:
            idx = np.clip(self.tier, 0, len(_TIER_BATTERY_MAH) - 1)
            object.__setattr__(
                self, "battery_mah",
                np.asarray(_TIER_BATTERY_MAH)[idx].astype(np.float64),
            )
        for name in ("compute_speed", "down_mbps", "up_mbps", "tier",
                     "energy_per_step", "battery_mah"):
            arr = getattr(self, name)
            if arr.shape != (k,):
                raise ValueError(
                    f"DeviceProfile.{name} must be shape ({k},), got {arr.shape}"
                )
        for name in ("compute_speed", "down_mbps", "up_mbps",
                     "energy_per_step", "battery_mah"):
            if not (np.asarray(getattr(self, name)) > 0).all():
                raise ValueError(f"DeviceProfile.{name} must be positive")

    @property
    def n_clients(self) -> int:
        return int(self.compute_speed.shape[0])


PROFILE_PRESETS: dict[str, Callable] = {}
AVAILABILITY_PRESETS: dict[str, type] = {}


def register_profile(name: str):
    def deco(fn):
        PROFILE_PRESETS[name] = fn
        return fn

    return deco


def register_availability(name: str):
    def deco(cls):
        AVAILABILITY_PRESETS[name] = cls
        return cls

    return deco


def list_profiles() -> list[str]:
    return sorted(PROFILE_PRESETS)


def list_availability_models() -> list[str]:
    return sorted(AVAILABILITY_PRESETS)


def make_profile(name: str, n_clients: int, seed: int = 0, **kwargs) -> DeviceProfile:
    """Build the registered profile preset ``name`` for ``n_clients``
    devices, seeded on the profile child stream of ``seed``."""
    if name not in PROFILE_PRESETS:
        raise ValueError(
            f"unknown device profile {name!r}; available: {list_profiles()}"
        )
    rng = np.random.default_rng([int(seed) & 0xFFFF_FFFF, PROFILE_STREAM])
    return PROFILE_PRESETS[name](n_clients, rng, **kwargs)


def make_availability(name: str, n_clients: int, seed: int = 0, **kwargs):
    if name not in AVAILABILITY_PRESETS:
        raise ValueError(
            f"unknown availability model {name!r}; available: "
            f"{list_availability_models()}"
        )
    return AVAILABILITY_PRESETS[name](n_clients, seed=seed, **kwargs)


# ----------------------------------------------------------- generators
@register_profile("uniform")
def uniform_profile(n_clients: int, rng: np.random.Generator, *,
                    speed: float = 25.0, down: float = 50.0,
                    up: float = 25.0) -> DeviceProfile:
    """Every device identical — the sanity baseline: without a deadline
    the simulated round time is a constant and nobody ever straggles."""
    del rng  # deterministic preset
    k = n_clients
    return DeviceProfile(
        compute_speed=np.full(k, float(speed)),
        down_mbps=np.full(k, float(down)),
        up_mbps=np.full(k, float(up)),
        tier=np.zeros(k, np.int64),
    )


@register_profile("zipf_compute")
def zipf_compute_profile(n_clients: int, rng: np.random.Generator, *,
                         exponent: float = 1.1, base_speed: float = 60.0,
                         down: float = 50.0, up: float = 25.0) -> DeviceProfile:
    """Compute speed ∝ 1 / rank^exponent over a random device ranking —
    a heavy straggler tail on the compute axis, uniform links."""
    k = n_clients
    rank = rng.permutation(k) + 1  # 1..K, shuffled
    speed = base_speed / rank.astype(np.float64) ** float(exponent)
    tier = np.clip((4 * (rank - 1)) // max(k, 1), 0, 3)
    return DeviceProfile(
        compute_speed=speed,
        down_mbps=np.full(k, float(down)),
        up_mbps=np.full(k, float(up)),
        tier=tier.astype(np.int64),
    )


# (speed steps/s, down Mbit/s, up Mbit/s) per tier: rough flagship /
# mid-range / low-end phone classes
_MOBILE_TIERS = ((60.0, 150.0, 75.0), (20.0, 50.0, 25.0), (5.0, 10.0, 5.0))


@register_profile("mobile_mix")
def mobile_mix_profile(n_clients: int, rng: np.random.Generator, *,
                       fractions: tuple = (0.2, 0.5, 0.3),
                       scatter: float = 0.25) -> DeviceProfile:
    """Three-tier phone fleet with lognormal per-device scatter — the
    cross-device regime (a ~12× compute spread and a ~15× link spread
    between the best flagship and the worst low-end device)."""
    fr = np.asarray(fractions, np.float64)
    if fr.shape != (3,) or (fr < 0).any() or fr.sum() <= 0:
        raise ValueError(
            f"mobile_mix fractions must be 3 non-negative weights, got {fractions}"
        )
    fr = fr / fr.sum()
    k = n_clients
    tier = rng.choice(3, size=k, p=fr)
    base = np.asarray(_MOBILE_TIERS)[tier]            # (K, 3)
    # mean-1 lognormal scatter per device per attribute
    s = float(scatter)
    noise = rng.lognormal(-0.5 * s * s, s, size=(k, 3)) if s > 0 else 1.0
    vals = base * noise
    return DeviceProfile(
        compute_speed=vals[:, 0],
        down_mbps=vals[:, 1],
        up_mbps=vals[:, 2],
        tier=tier.astype(np.int64),
    )


# --------------------------------------------------------- availability
class AvailabilityModel:
    """Base trace: everyone always online.  ``mask(t)`` is deterministic
    per (seed, t) — the contract every backend's gating relies on."""

    name = "always"

    def __init__(self, n_clients: int, seed: int = 0):
        self.K = int(n_clients)
        self.seed = int(seed) & 0xFFFF_FFFF

    def mask(self, t: int) -> np.ndarray:
        """(K,) bool — client online states at round ``t``."""
        del t
        return np.ones(self.K, bool)

    def _rng(self, t: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, AVAILABILITY_STREAM, int(t)])


register_availability("always")(AvailabilityModel)


@register_availability("bernoulli")
class BernoulliAvailability(AvailabilityModel):
    """i.i.d. per round: client i online w.p. ``p`` (no memory)."""

    name = "bernoulli"

    def __init__(self, n_clients: int, seed: int = 0, *, p: float = 0.9):
        super().__init__(n_clients, seed)
        if not 0.0 < p <= 1.0:
            raise ValueError(f"bernoulli availability needs 0 < p <= 1, got {p}")
        self.p = float(p)

    def mask(self, t: int) -> np.ndarray:
        return self._rng(t).random(self.K) < self.p


@register_availability("markov")
class MarkovAvailability(AvailabilityModel):
    """Per-client two-state on/off chain: on→off w.p. ``p_drop``,
    off→on w.p. ``p_join``; round-0 states from the stationary
    distribution.  The trace is materialized incrementally and cached,
    so ``mask(t)`` is O(1) after the first visit and identical however
    many times (or in whatever chunking) the backends replay it."""

    name = "markov"

    def __init__(self, n_clients: int, seed: int = 0, *,
                 p_drop: float = 0.1, p_join: float = 0.5):
        super().__init__(n_clients, seed)
        for label, p in (("p_drop", p_drop), ("p_join", p_join)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"markov availability {label} must be in [0, 1]")
        if p_drop + p_join <= 0:
            raise ValueError("markov availability needs p_drop + p_join > 0")
        self.p_drop, self.p_join = float(p_drop), float(p_join)
        self._trace: list[np.ndarray] = []

    def mask(self, t: int) -> np.ndarray:
        while len(self._trace) <= t:
            step = len(self._trace)
            rng = self._rng(step)
            if step == 0:
                p_on = self.p_join / (self.p_join + self.p_drop)
                state = rng.random(self.K) < p_on
            else:
                prev = self._trace[-1]
                u = rng.random(self.K)
                state = np.where(prev, u >= self.p_drop, u < self.p_join)
            self._trace.append(state)
        return self._trace[t]


@register_availability("trace")
class TraceAvailability(AvailabilityModel):
    """Replay a recorded per-client on/off schedule from a file —
    measured fleet traces instead of a synthetic process.

    Formats (chosen by file extension):

    - ``.csv``  — one row per round, ``n_clients`` comma-separated 0/1
      columns; ``#`` lines are comments.
    - ``.json`` — ``{"rounds": [[0/1, ...], ...]}``.

    ``wrap=True`` (default) cycles the schedule past its last row (round
    ``t`` replays row ``t mod T``); ``wrap=False`` holds the final row
    forever.  The trace is fully deterministic — no rng is ever drawn,
    the seed is ignored — so every backend (and a resumed run) replays
    the identical fleet history.
    """

    name = "trace"

    def __init__(self, n_clients: int, seed: int = 0, *,
                 path: str, wrap: bool = True):
        super().__init__(n_clients, seed)
        rows = self._load(str(path))
        sched = np.asarray(rows)
        if sched.ndim != 2 or sched.shape[0] == 0:
            raise ValueError(
                f"availability trace {path!r} must be a non-empty 2-D "
                f"(rounds × clients) schedule, got shape {sched.shape}"
            )
        if sched.shape[1] != self.K:
            raise ValueError(
                f"availability trace {path!r} has {sched.shape[1]} client "
                f"columns but the run has n_clients={self.K}"
            )
        vals = sched.astype(np.float64)
        if not np.isin(vals, (0.0, 1.0)).all():
            raise ValueError(
                f"availability trace {path!r} must contain only 0/1 "
                f"entries"
            )
        self.path = str(path)
        self.schedule = vals.astype(bool)
        self.wrap = bool(wrap)

    @staticmethod
    def _load(path: str):
        if path.endswith(".json"):
            import json

            with open(path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict) or "rounds" not in doc:
                raise ValueError(
                    f"JSON availability trace {path!r} must be an object "
                    f'with a "rounds" key holding the schedule'
                )
            return doc["rounds"]
        if path.endswith(".csv"):
            rows = np.loadtxt(path, delimiter=",", comments="#", ndmin=2)
            return rows
        raise ValueError(
            f"availability trace {path!r} must be a .csv or .json file"
        )

    def mask(self, t: int) -> np.ndarray:
        n = self.schedule.shape[0]
        i = int(t) % n if self.wrap else min(int(t), n - 1)
        return self.schedule[i].copy()
