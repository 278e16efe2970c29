"""Serving substrate: batched request scheduling over the decode path."""

from repro_torch.serving.scheduler import BatchScheduler, Request

__all__ = ["Request", "BatchScheduler"]
