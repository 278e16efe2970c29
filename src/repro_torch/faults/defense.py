"""Server-side update validation gate, ported from ``repro.faults.defense``
(the reference's DESIGN.md §14.2).

Two-stage screening of arrived client updates, in torch ops on the
cohort's device with no host read, so the same code runs eagerly and
inside a captured round chunk:

1. **Non-finite screening** — any NaN/Inf entry flags the row.
2. **Norm gating at a robust quantile** — with ``thr`` the
   ``clip_quantile`` of the finite valid cohort delta norms, rows with
   ``norm > norm_tolerance · thr`` are flagged (quarantine candidates),
   and rows in the band ``(thr, tol·thr]`` are norm-clipped back to
   ``thr``.

The reference has no Pallas kernel here (``jnp``), and neither has the
port: the norms and the clip are plain torch, in column chunks of the
(m, P) cohort, so no (m, P) temporary exists beside the clip's output.

Invariants (the reference's):

- Rows with ``norm <= thr`` pass through **bit-exactly**.
- When *no* valid finite row exists the quantile is NaN and every valid
  row is flagged.
- Flagged rows are never clipped, and non-finite rows are *neutralized*
  — replaced by the fetched params — because a zero weight does not
  protect a weighted sum from ``0 · NaN = NaN``.

The norms sum each row's squares over the flat row in column chunks,
where the reference sums per leaf: the same values to fp32 rounding (the
tests hold them to 1e-5 relative).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["update_norms", "validate_updates", "screen_norms", "nanquantile"]

_COLUMNS = 1 << 24  # columns a pass of the norms and the clip


def update_norms(stacked: torch.Tensor, fetched: torch.Tensor):
    """Per-row global L2 delta norm and all-finite flag of the (m, P)
    cohort against the (P,) fetched params.

    Returns ``(norm, finite)`` — ``norm`` is ``inf`` on non-finite rows
    so downstream comparisons never propagate NaN.
    """
    m, n = stacked.shape
    sq = torch.zeros(m, dtype=torch.float32, device=stacked.device)
    finite = torch.ones(m, dtype=torch.bool, device=stacked.device)
    for c0 in range(0, n, _COLUMNS):
        s = stacked[:, c0:c0 + _COLUMNS].to(torch.float32)
        finite &= torch.isfinite(s).all(dim=1)
        d = s - fetched[c0:c0 + _COLUMNS].to(torch.float32)[None]
        sq += d.square_().sum(dim=1)
    return torch.where(finite, torch.sqrt(sq), torch.inf), finite


def nanquantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q`` quantile of the non-NaN entries of the 1-D ``x`` with
    linear interpolation, NaN when every entry is NaN: the arithmetic of
    ``jnp.nanquantile`` (float32 ranks, ``low·(1−w) + high·w``), from a
    sort and gathers, so it makes no host read."""
    s = torch.sort(x).values  # NaN sorts last
    counts = (~torch.isnan(x)).sum().to(torch.float32)
    rank = np.float32(q).item() * (counts - 1.0)
    low, high = torch.floor(rank), torch.ceil(rank)
    hw = rank - low
    lw = 1.0 - hw
    last = counts - 1.0
    low = torch.clamp(torch.minimum(low, last), min=0.0).to(torch.int64).reshape(1)
    high = torch.clamp(torch.minimum(high, last), min=0.0).to(torch.int64).reshape(1)
    return (s.gather(0, low) * lw + s.gather(0, high) * hw)[0]


def validate_updates(stacked: torch.Tensor, fetched: torch.Tensor, valid: torch.Tensor, *,
                     q: float, tol: float):
    """The full gate: screen + clip one (m, P) cohort.

    ``valid`` (m,) bool marks rows that actually arrived (systems
    survivors / admitted clients); invalid rows are ignored by the
    quantile and never flagged or clipped.

    Returns ``(clipped_stack, flagged, norm)``.
    """
    norm, finite = update_norms(stacked, fetched)
    masked = torch.where(valid & finite, norm, torch.nan)
    thr = nanquantile(masked, q)
    # NaN thr (no valid finite row) makes `norm <= tol*thr` False for
    # every row -> all valid rows flagged, none clipped.
    flagged = valid & (~finite | ~(norm <= np.float32(tol).item() * thr))
    scale = torch.where(norm > thr, thr / torch.clamp(norm, min=1e-30), 1.0)
    scale = torch.where(flagged | ~valid, 1.0, scale)
    sc, nt, keep = scale[:, None], (~finite)[:, None], (scale >= 1.0)[:, None]
    out = torch.empty_like(stacked)
    for c0 in range(0, stacked.shape[1], _COLUMNS):
        s = stacked[:, c0:c0 + _COLUMNS]
        f = fetched[c0:c0 + _COLUMNS][None]
        g32 = f.to(torch.float32)
        clipped = (g32 + (s.to(torch.float32) - g32) * sc).to(s.dtype)
        out[:, c0:c0 + _COLUMNS] = torch.where(nt, f.to(s.dtype),
                                               torch.where(keep, s, clipped))
    return out, flagged, norm


def screen_norms(norms, finite, valid, *, q: float, tol: float):
    """Host-side (numpy) twin of the norm gate for the async buffer, where
    candidate sets are small and data-dependent.  Same thresholds and
    flagging rule as ``validate_updates``; returns ``(flagged, scales,
    thr)`` with ``scales`` the per-row clip factor (1.0 where untouched)."""
    norms = np.asarray(norms, np.float64)
    finite = np.asarray(finite, bool)
    valid = np.asarray(valid, bool)
    ok = valid & finite
    thr = float(np.quantile(norms[ok], q)) if ok.any() else float("nan")
    if not np.isfinite(thr):
        return valid.copy(), np.ones_like(norms), thr
    flagged = valid & (~finite | ~(norms <= tol * thr))
    with np.errstate(divide="ignore", invalid="ignore"):
        scales = np.where(norms > thr, thr / norms, 1.0)
    scales = np.where(valid & ~flagged, scales, 1.0)
    return flagged, scales, thr
