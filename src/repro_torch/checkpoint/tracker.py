"""Metrics trackers, ported from ``repro.checkpoint.tracker``: a seam for
streaming ``RoundResult`` records somewhere durable.

The engine's in-memory ``history`` dies with the process; a
``MetricsTracker`` attached with ``make_engine(..., tracker=...)`` (or
``engine.trackers.append(...)``) receives every round — evaluated or not
— as it is committed, before any checkpoint fires for that round.

Delivery is **at least once** under resume: a killed run may have logged
rounds past its last checkpoint, so after a restore the same round can
appear twice in the stream.  Rows carry the round index; readers dedupe
on it, keeping the last occurrence (``read_jsonl``).

``JsonlTracker`` writes one JSON object a line, flushed a row, so a kill
loses at most the line in flight.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

__all__ = ["MetricsTracker", "JsonlTracker", "read_jsonl"]


def _to_builtin(x: Any) -> Any:
    """Numpy and torch scalars and arrays, recursively, as plain Python for
    ``json``."""
    if isinstance(x, dict):
        return {k: _to_builtin(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_builtin(v) for v in x]
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, np.bool_):
        return bool(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, torch.Tensor):
        return x.item() if x.ndim == 0 else x.tolist()
    return x


class MetricsTracker:
    """Base tracker: subclasses override ``log_round``; ``close`` runs from
    ``engine.close_trackers()``."""

    def log_round(self, result) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


class JsonlTracker(MetricsTracker):
    """Append-only JSONL, one line a round.

    Each line holds every ``RoundResult`` field (``round``, ``selected`` as
    a list, ``mean_selected_loss``, ``comm_mb``, ``test_loss`` /
    ``test_acc`` (null on an unevaluated round), ``sim_time`` /
    ``sim_clock`` / ``n_dropped``, ``metrics``, ``staleness``,
    ``params_version``, ``n_faulty`` / ``n_quarantined``), keys sorted."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def log_round(self, result) -> None:
        row = _to_builtin(dataclasses.asdict(result))
        self._f.write(json.dumps(row, sort_keys=True) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.flush()
        try:
            os.fsync(self._f.fileno())
        except OSError:
            pass
        self._f.close()


def read_jsonl(path: str) -> list[dict]:
    """A tracker file's rows, deduped by round (the last occurrence wins:
    the at-least-once contract under resume), in round order."""
    by_round: dict[int, dict] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            by_round[int(row["round"])] = row
    return [by_round[r] for r in sorted(by_round)]
