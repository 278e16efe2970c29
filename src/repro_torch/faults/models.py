"""Registered per-client fault models, ported from ``repro.faults.models``
(the reference's DESIGN.md §14).

A fault model transforms the *trained* client payload before it reaches
the server: ``apply(stacked, fetched, u, leaves)`` maps the (m, P) cohort
of flat parameter vectors and the fetched (P,) global parameters to a
corrupted (m, P) cohort, in torch ops that make no host read, so the same
transform runs eagerly (host and compiled rounds) and inside a captured
round chunk.  The engine mixes the transformed rows back in with a per-row
kind mask, so ``apply`` never needs to know *which* rows are faulty.

``leaves`` is the reference's parameter leaves as stretches of the flat
vector (``repro_torch.convert.leaf_segments``; ``None``: the row is one
leaf).  ``label_flip`` and ``truncated_upload`` act leaf by leaf, as the
reference's ``jax.tree.map`` does; over a whole flat row they would give
another answer.

Per-model randomness is a single scalar ``u`` per (round, client) drawn
host-side on the dedicated fault stream (``FAULT_STREAM``), numpy as in
the reference, so the draws are the reference's.

``traced = False`` models (``stale_replay``: it needs the cross-round
replay cache) are rejected with ``fuse_rounds > 0`` by ``FLConfig`` and
handled by ``FaultRuntime``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.registry import Registry

__all__ = [
    "FAULT_REGISTRY",
    "FAULT_STREAM",
    "FaultModel",
    "register_fault",
    "list_faults",
    "build_fault",
]

# Child-stream tag for the fault axis — sibling of the systems streams
# (PROFILE/AVAILABILITY/JITTER = 0x5E3D_0001..3).
FAULT_STREAM = 0x5E3D_0004

FAULT_REGISTRY = Registry("fault")
register_fault = FAULT_REGISTRY.register


def list_faults() -> list[str]:
    return FAULT_REGISTRY.names()


def build_fault(name: str, **kwargs):
    return FAULT_REGISTRY.build(name, **kwargs)


def _leaves(leaves, n: int) -> list[list[tuple[int, int]]]:
    return [[(0, n)]] if leaves is None else leaves


def _leafwise(stacked, fetched, leaves, one):
    """Apply ``one(s, g)`` to each leaf: ``s`` the (m, size) rows of
    the leaf's stretches side by side, ``g`` its (size,) fetched values,
    and write the (m, size) result back over the stretches."""
    out = torch.empty_like(stacked)
    for segs in _leaves(leaves, stacked.shape[1]):
        s = torch.cat([stacked[:, a:b] for a, b in segs], dim=1)
        g = torch.cat([fetched[a:b] for a, b in segs])
        res, off = one(s, g), 0
        for a, b in segs:
            out[:, a:b] = res[:, off:off + b - a]
            off += b - a
    return out


def _f32(x: float) -> float:
    """``x`` rounded to float32, as JAX rounds a Python scalar that meets a
    float32 array: a product with a float32 tensor is then the float32
    product whether torch computes it in float32 or in float64."""
    return float(np.float32(x))


def truncation_keep(u: torch.Tensor, size: int) -> torch.Tensor:
    """(m, size) bool: which of a leaf's ``size`` entries arrive at upload
    fraction ``u``, computed as the reference does, in float32: position
    ``i`` (rounded to float32, as ``jnp.arange(size, dtype=float32)``)
    against ``u · size`` (both rounded to float32).  Above 2^24 entries the
    float32 positions are not exact, so an integer compare would move the
    cut point."""
    pos = torch.arange(size, device=u.device).to(torch.float32)
    cut = u.to(torch.float32)[:, None] * _f32(size)
    return pos[None, :] < cut


class FaultModel:
    """Base class: one registered client-fault behaviour.

    - ``draw_param(rng, n)`` — one float per client from the dedicated
      fault rng; models that need no parameter still draw.
    - ``upload_fraction(u)`` — fraction of the update's bytes that reach
      the server (``CommModel`` partial-byte accounting); 1.0 for
      everything except ``truncated_upload``.
    - ``apply(stacked, fetched, u, leaves)`` — corruption of the whole
      (m, P) stack; the caller masks in the faulty rows.
    """

    name: str = ""
    traced: bool = True

    def draw_param(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.random(n)

    def upload_fraction(self, u: np.ndarray) -> np.ndarray:
        return np.ones_like(np.asarray(u, dtype=np.float64))

    def apply(self, stacked, fetched, u, leaves=None):
        raise NotImplementedError


@register_fault("nan_update")
class NanUpdate(FaultModel):
    """Client returns non-finite parameters (crashed optimizer, fp overflow)."""

    name = "nan_update"

    def apply(self, stacked, fetched, u, leaves=None):
        return torch.full_like(stacked, float("nan"))


@register_fault("exploding")
class Exploding(FaultModel):
    """Client delta scaled by ``eta`` — scaled-gradient poisoning or
    diverged local training."""

    name = "exploding"

    def __init__(self, eta: float = 100.0):
        if not eta > 1.0:
            raise ValueError(f"exploding eta must be > 1, got {eta}")
        self.eta = float(eta)

    def apply(self, stacked, fetched, u, leaves=None):
        g = fetched.to(torch.float32)[None]
        return (g + _f32(self.eta) * (stacked.to(torch.float32) - g)).to(stacked.dtype)


@register_fault("sign_flip")
class SignFlip(FaultModel):
    """Byzantine sign flip: θ′ = θ_g − (θ_i − θ_g).  Norm-preserving, so
    norm screening alone cannot catch it — the robust aggregators can."""

    name = "sign_flip"

    def apply(self, stacked, fetched, u, leaves=None):
        g = fetched.to(torch.float32)[None]
        return (2.0 * g - stacked.to(torch.float32)).to(stacked.dtype)


@register_fault("label_flip")
class LabelFlip(FaultModel):
    """Proxy for label-flipped local training: each leaf's delta is
    replaced by its reversal, negated — norm-preserving, so the update
    looks plausible but pulls toward a wrong optimum."""

    name = "label_flip"

    def apply(self, stacked, fetched, u, leaves=None):
        def one(s, g):
            g32 = g.to(torch.float32)[None]
            garbled = -torch.flip(s.to(torch.float32) - g32, dims=(1,))
            return (g32 + garbled).to(s.dtype)

        return _leafwise(stacked, fetched, leaves, one)


@register_fault("stale_replay")
class StaleReplay(FaultModel):
    """Client re-sends its *previous* trained params instead of fresh work
    (stuck cache, duplicated upload).  Needs the cross-round replay cache
    of ``FaultRuntime``, so it is not traced (rejected with
    ``fuse_rounds > 0``); ``apply`` is the first-offense fallback — nothing
    cached yet, the client echoes the fetched params (a zero delta)."""

    name = "stale_replay"
    traced = False

    def apply(self, stacked, fetched, u, leaves=None):
        return fetched.to(stacked.dtype)[None].expand_as(stacked)


@register_fault("truncated_upload")
class TruncatedUpload(FaultModel):
    """Upload cut short at a uniform fraction ``u ∈ [min_frac, max_frac]``:
    the first ``u·size`` entries of each leaf arrive, the tail keeps the
    fetched (stale) values.  Only the partial bytes are charged to
    ``CommModel`` via ``upload_fraction``."""

    name = "truncated_upload"

    def __init__(self, min_frac: float = 0.25, max_frac: float = 0.75):
        if not (0.0 <= min_frac <= max_frac <= 1.0):
            raise ValueError(
                f"need 0 <= min_frac <= max_frac <= 1, got ({min_frac}, {max_frac})"
            )
        self.min_frac = float(min_frac)
        self.max_frac = float(max_frac)

    def draw_param(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return self.min_frac + (self.max_frac - self.min_frac) * rng.random(n)

    def upload_fraction(self, u: np.ndarray) -> np.ndarray:
        return np.asarray(u, dtype=np.float64)

    def apply(self, stacked, fetched, u, leaves=None):
        def one(s, g):
            keep = truncation_keep(u, s.shape[1])
            return torch.where(keep, s, g.to(s.dtype)[None])

        return _leafwise(stacked, fetched, leaves, one)
