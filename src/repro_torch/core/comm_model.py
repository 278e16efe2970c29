"""Communication accounting (paper §V-C, Table III), ported from
``repro.core.comm_model``.

  per round:  m * P * bytes_per_param          (model download to selected)
            + m * P * upload_bytes_per_param   (update upload from selected)
            + K * 4                     (loss scalars, if the strategy polls)
  one-time:   K * C * 4                 (label histograms, if used)
            + K * 4                     (cluster assignments pushed back)
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["CommModel", "count_params"]

_MB = 1024.0 * 1024.0


def count_params(params: torch.Tensor) -> int:
    """Total parameter count of the flat (P,) parameter vector."""
    return int(params.numel())


@dataclass
class CommModel:
    n_params: int
    K: int
    n_classes: int
    bytes_per_param: int = 4
    upload_bytes_per_param: float | None = None  # None → bytes_per_param

    def __post_init__(self) -> None:
        if self.upload_bytes_per_param is None:
            self.upload_bytes_per_param = float(self.bytes_per_param)

    def model_mb(self) -> float:
        return self.n_params * self.bytes_per_param / _MB

    def one_time_mb(self, needs_histograms: bool) -> float:
        if not needs_histograms:
            return 0.0
        hist = self.K * self.n_classes * 4
        assignments = self.K * 4
        return (hist + assignments) / _MB

    def round_mb(self, m_selected: int, needs_losses: bool,
                 m_uploaded: int | None = None,
                 n_polled: int | None = None) -> float:
        """Bytes of one round.  ``m_uploaded`` (default: ``m_selected``)
        counts the updates that arrived; ``n_polled`` (default: ``K``)
        the clients the loss poll reached."""
        if m_uploaded is None:
            m_uploaded = m_selected
        if n_polled is None:
            n_polled = self.K
        model_traffic = self.n_params * (
            m_selected * self.bytes_per_param
            + m_uploaded * self.upload_bytes_per_param
        )
        loss_poll = n_polled * 4 if needs_losses else 0
        return (model_traffic + loss_poll) / _MB

    def total_mb(
        self, rounds: int, m_selected: int, needs_losses: bool, needs_histograms: bool
    ) -> float:
        return self.one_time_mb(needs_histograms) + rounds * self.round_mb(
            m_selected, needs_losses
        )

    def average_round_mb(
        self, rounds: int, m_selected: int, needs_losses: bool, needs_histograms: bool
    ) -> float:
        """Table III's "average communication overhead" (MB per round,
        one-time costs amortized)."""
        return self.total_mb(rounds, m_selected, needs_losses, needs_histograms) / rounds
