"""``AsyncConfig`` — the validated, JSON-safe slot behind
``FLConfig.async_mode``, ported from ``repro.engine.async_config``
(numpy, as in the reference, with its error texts).

Everything here survives ``FLConfig.to_dict()`` / ``from_dict`` (plain
scalars, strings, kwargs dicts); the runtime (the in-flight ledger, the
event clock) lives in ``repro_torch.engine.async_engine``.  The module
also owns the two pure cores of the async server rule:

- staleness discounts, registered like aggregators
  (``@register_staleness``): ``constant`` (discount off),
  ``polynomial`` (FedBuff's ``(1+s)^-a``), ``exponential``
  (``gamma^s``);
- ``staleness_weights`` — the normalized aggregation weights of one
  popped buffer (non-negative, unit sum over the surviving mass,
  permutation-equivariant);
- ``arrival_order`` — the event queue's deterministic order of a
  dispatched cohort's uploads.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Callable

import numpy as np

from repro_torch.engine.registry import (
    STALENESS_REGISTRY,
    list_staleness_discounts,
    register_staleness,
)

__all__ = [
    "AsyncConfig",
    "arrival_order",
    "make_staleness_discount",
    "staleness_weights",
]

_DISPATCH_MODES = ("async", "sync")


# ------------------------------------------------------------ discounts
@register_staleness("constant")
def constant_discount(staleness: np.ndarray, *, factor: float = 1.0) -> np.ndarray:
    """d(s) = factor — discount off.  A constant scale cancels in the
    normalized weights, so this is the degenerate-equivalence setting."""
    return np.full_like(np.asarray(staleness, np.float64), float(factor))


@register_staleness("polynomial")
def polynomial_discount(staleness: np.ndarray, *, a: float = 0.5) -> np.ndarray:
    """FedBuff's polynomial discount d(s) = (1 + s)^-a (a=0.5 is the
    paper's 1/sqrt(1+s))."""
    return (1.0 + np.asarray(staleness, np.float64)) ** (-float(a))


@register_staleness("exponential")
def exponential_discount(staleness: np.ndarray, *, gamma: float = 0.5) -> np.ndarray:
    """d(s) = gamma^s — a harsher tail than polynomial."""
    return float(gamma) ** np.asarray(staleness, np.float64)


def make_staleness_discount(name: str, **kwargs) -> Callable[[np.ndarray], np.ndarray]:
    """Bind a registered discount to its kwargs; validates eagerly (the
    bound function is probed on a zero staleness) so a bad kwarg fails
    at config construction, not mid-run."""
    fn = STALENESS_REGISTRY[name]

    def bound(staleness: np.ndarray) -> np.ndarray:
        return fn(staleness, **kwargs)

    probe = np.asarray(bound(np.zeros(1, np.int64)), np.float64)
    if probe.shape != (1,) or not np.isfinite(probe).all() or (probe < 0).any():
        raise ValueError(
            f"staleness discount {name!r} with kwargs {kwargs} must map "
            f"staleness to finite non-negative factors; probe gave {probe}"
        )
    return bound


# ----------------------------------------------------------- pure cores
def staleness_weights(sizes: np.ndarray, staleness: np.ndarray,
                      discount: Callable[[np.ndarray], np.ndarray],
                      max_staleness: int | None = None) -> np.ndarray:
    """Aggregation weights over one popped buffer.

    ``w_i ∝ size_i · d(s_i)``, zeroed where ``s_i > max_staleness`` and
    normalized over the surviving mass — non-negative, summing to 1
    whenever anything survives (all-zero when nothing does), and
    permutation-equivariant in the buffer order (the property suite
    asserts all three for arbitrary arrival permutations).
    """
    sizes = np.asarray(sizes, np.float64)
    staleness = np.asarray(staleness, np.int64)
    if sizes.shape != staleness.shape:
        raise ValueError(
            f"sizes and staleness must share a shape; got {sizes.shape} "
            f"vs {staleness.shape}"
        )
    u = sizes * np.asarray(discount(staleness), np.float64)
    if max_staleness is not None:
        u = np.where(staleness <= int(max_staleness), u, 0.0)
    total = u.sum()
    if total <= 0.0:
        return np.zeros_like(u)
    return u / total


def arrival_order(sel: np.ndarray, reached: np.ndarray,
                  arrival_t: np.ndarray) -> np.ndarray:
    """Deterministic upload ordering of one dispatched cohort: reachable
    clients sorted by ``(arrival time, client index)``; unreachable ones
    never enter the queue.  With no deadline, the resulting survivor set
    equals ``RoundClock.round_outcome``'s (asserted in test_systems.py).
    """
    sel = np.asarray(sel, np.int64)
    reached = np.asarray(reached, bool)
    arrival_t = np.asarray(arrival_t, np.float64)
    if not (sel.shape == reached.shape == arrival_t.shape):
        raise ValueError("sel, reached, and arrival_t must share a shape")
    live = np.flatnonzero(reached)
    order = np.lexsort((sel[live], arrival_t[live]))
    return sel[live[order]]


# --------------------------------------------------------------- config
@dataclass
class AsyncConfig:
    """The asynchronous-runtime axis of one federated experiment
    (FedBuff-style).

    - ``buffer_k`` — the server aggregates as soon as this many in-
      flight uploads have arrived (``None`` → the dispatched cohort size
      ``m_eff``, the degenerate buffer).
    - ``dispatch`` — ``"async"`` (the server keeps ``concurrency``
      clients in flight and never waits for a full cohort) or ``"sync"``
      (lock-step emulation: one cohort dispatched and fully awaited per
      step — the degenerate configuration that must stay bit-identical
      to the synchronous engine).
    - ``concurrency`` — target number of in-flight clients under
      ``dispatch="async"`` (``None`` → ``max(2·buffer_k, m_eff)``).
      Must cover ``buffer_k``, else an aggregation step could never
      gather a full buffer.
    - ``staleness`` / ``staleness_kwargs`` — registered discount applied
      to an update trained against a params version ``s`` aggregations
      old (``constant`` = off, ``polynomial`` = FedBuff's ``(1+s)^-a``,
      ``exponential`` = ``gamma^s``).
    - ``max_staleness`` — arrivals staler than this are dropped with
      exactly zero weight (``None`` = keep everything).
    """

    buffer_k: int | None = None
    dispatch: str = "async"
    concurrency: int | None = None
    staleness: str = "constant"
    staleness_kwargs: dict = field(default_factory=dict)
    max_staleness: int | None = None

    def __post_init__(self) -> None:
        if self.dispatch not in _DISPATCH_MODES:
            raise ValueError(
                f"dispatch must be one of {_DISPATCH_MODES}, got "
                f"{self.dispatch!r}"
            )
        if self.buffer_k is not None and not (
            isinstance(self.buffer_k, int) and self.buffer_k >= 1
        ):
            raise ValueError(
                f"buffer_k must be a positive int (or None = the cohort "
                f"size), got {self.buffer_k!r}"
            )
        if self.concurrency is not None and not (
            isinstance(self.concurrency, int) and self.concurrency >= 1
        ):
            raise ValueError(
                f"concurrency must be a positive int (or None = "
                f"max(2·buffer_k, m_eff)), got {self.concurrency!r}"
            )
        if self.staleness not in list_staleness_discounts():
            raise ValueError(
                f"unknown staleness discount {self.staleness!r}; "
                f"available: {list_staleness_discounts()}"
            )
        if not isinstance(self.staleness_kwargs, dict):
            raise ValueError("staleness_kwargs must be a dict")
        # bad discount kwargs fail here, not mid-run
        make_staleness_discount(self.staleness, **self.staleness_kwargs)
        if self.max_staleness is not None and not (
            isinstance(self.max_staleness, int) and self.max_staleness >= 0
        ):
            raise ValueError(
                f"max_staleness must be a non-negative int (or None = "
                f"unbounded), got {self.max_staleness!r}"
            )

    # ------------------------------------------------------------------
    def buffer_effective(self, m_eff: int) -> int:
        """Resolved buffer size: ``buffer_k`` or the cohort size."""
        return int(self.buffer_k) if self.buffer_k is not None else int(m_eff)

    def concurrency_effective(self, m_eff: int) -> int:
        """Resolved in-flight target under ``dispatch="async"``."""
        if self.concurrency is not None:
            return int(self.concurrency)
        return max(2 * self.buffer_effective(m_eff), int(m_eff))

    def discount_off(self) -> bool:
        """True when the configured discount is the identity — part of
        the degenerate-equivalence contract."""
        return self.staleness == "constant" and float(
            self.staleness_kwargs.get("factor", 1.0)
        ) == 1.0

    @classmethod
    def from_dict(cls, d: dict) -> "AsyncConfig":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown AsyncConfig keys: {sorted(unknown)}")
        return cls(**d)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def validate_async_combination(cfg) -> None:
    """Cross-field validation of ``FLConfig.async_mode`` against the rest
    of the config (called from ``FLConfig.__post_init__``; single-sourced
    here so the engine-level guard never drifts from it)."""
    acfg: AsyncConfig = cfg.async_mode
    _require(
        cfg.backend in ("host", "compiled"),
        f"async_mode runs on backend='host' or 'compiled' (the event loop "
        f"drives the eager round hooks); got backend={cfg.backend!r}",
    )
    _require(
        cfg.fuse_rounds == 0,
        "async_mode and fuse_rounds > 0 are mutually exclusive — the "
        "fused scan is a lock-step execution mode; set fuse_rounds=0",
    )
    _require(
        cfg.aggregator == "fedavg",
        f"async_mode aggregates staleness-weighted client deltas (fedavg "
        f"semantics); got aggregator={cfg.aggregator!r}",
    )
    _require(
        cfg.client_mode == "plain",
        f"async_mode supports client_mode='plain' only (per-client state "
        f"has no defined semantics for concurrent in-flight training); "
        f"got {cfg.client_mode!r}",
    )
    _require(
        cfg.compress_bits == 0,
        "async_mode aggregates deltas outside the compiled mask-gated "
        "reduce; compress_bits > 0 is not supported with it",
    )
    _require(
        cfg.systems is not None,
        "async_mode needs the systems axis for arrival times — set "
        "FLConfig.systems (SystemsConfig() is the inert baseline)",
    )
    m_eff = cfg.systems.m_effective(cfg.m, cfg.n_clients)
    if acfg.dispatch == "sync":
        _require(
            acfg.buffer_k is None or acfg.buffer_k == m_eff,
            f"dispatch='sync' awaits the whole dispatched cohort, so "
            f"buffer_k must be None or the cohort size {m_eff}; got "
            f"{acfg.buffer_k}",
        )
    else:
        _require(
            cfg.systems.deadline_s is None,
            "dispatch='async' replaces the round deadline with staleness "
            "discounting (stragglers arrive late instead of being "
            "dropped); set systems.deadline_s=None or use "
            "dispatch='sync'",
        )
        k = acfg.buffer_effective(m_eff)
        conc = acfg.concurrency_effective(m_eff)
        _require(
            conc >= k,
            f"concurrency ({conc}) must cover buffer_k ({k}) — with fewer "
            f"clients in flight than the buffer, an aggregation step "
            f"could never fire",
        )
        _require(
            k <= cfg.n_clients,
            f"buffer_k ({k}) cannot exceed the population "
            f"({cfg.n_clients})",
        )
