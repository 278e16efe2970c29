"""repro_torch.systems — the systems axis of the federated engine, ported
from ``repro.systems`` (the reference's DESIGN.md §10).

Host-side numpy, as in the reference, with the same ``np.random.default_rng``
child streams and the same order of draws, so profiles, availability
masks, per-round times, deadline arrivals, ``latency_hint`` and
``RoundOutcome`` are bit-identical to the reference's for one seed:

- ``profiles``  — per-client ``DeviceProfile`` (compute speed, up/down
                  bandwidth, tier, energy) with the registered presets
                  ``uniform``, ``zipf_compute`` and ``mobile_mix``, and the
                  availability models ``always``, ``bernoulli``, ``markov``
                  and ``trace`` (a CSV or JSON schedule).
- ``clock``     — ``RoundClock`` (download + steps / speed · jitter +
                  upload, in simulated seconds) and ``round_outcome`` (the
                  deadline policy on a dispatched cohort).
- ``config``    — ``SystemsConfig``, the validated slot behind
                  ``FLConfig.systems``.
- ``runtime``   — ``SystemsRuntime``, what the round loop consults: the
                  availability mask, per-client times, the cohort's
                  outcome and the battery ledger.

The engine dispatches ``ceil(m · over_select)`` clients; offline
clients enter selection as ``-inf`` losses, and dropped ones keep their
cohort slot at aggregation weight zero on the compiled and fused
backends (the host backend reduces the survivors' rows).
"""

from repro_torch.systems.clock import RoundClock, RoundOutcome, round_outcome
from repro_torch.systems.config import SystemsConfig
from repro_torch.systems.profiles import (
    AVAILABILITY_PRESETS,
    PROFILE_PRESETS,
    AvailabilityModel,
    DeviceProfile,
    list_availability_models,
    list_profiles,
    make_availability,
    make_profile,
)
from repro_torch.systems.runtime import SystemsRuntime

__all__ = [
    "AVAILABILITY_PRESETS",
    "PROFILE_PRESETS",
    "AvailabilityModel",
    "DeviceProfile",
    "RoundClock",
    "RoundOutcome",
    "SystemsConfig",
    "SystemsRuntime",
    "list_availability_models",
    "list_profiles",
    "make_availability",
    "make_profile",
    "round_outcome",
]
