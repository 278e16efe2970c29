"""When to save, where, and what to keep, ported from
``repro.checkpoint.policy``.

``CheckpointPolicy`` is the declarative half — save every N rounds
and/or every T seconds, keep the last k files.  ``Checkpointer`` binds a
policy to a directory and is driven from the engine's ``rounds()``
stream: ``maybe_save(engine, rnd)`` runs after round ``rnd`` is committed,
writes through ``repro_torch.checkpoint.serializer`` (tmp + fsync +
rename) and prunes old files to ``keep_last``.

Round triggers are **absolute**: a save fires after round ``rnd`` iff
``(rnd + 1) % every_rounds == 0``, a function of the round index alone,
whatever round a ``rounds()`` call started at.  The fused backend ends
its chunks at these save points, so a resumed run replays the same chunk
pattern.

Files are named ``round_<NNNNNNNN>.ckpt``, the number being the *next*
round to run (``engine._round`` at save time), so the newest file is the
lexicographic maximum.
"""

from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass
from typing import Callable

__all__ = [
    "CheckpointPolicy",
    "Checkpointer",
    "latest_checkpoint",
    "checkpoint_paths",
]

_CKPT_RE = re.compile(r"^round_(\d{8})\.ckpt$")


def _ckpt_name(next_round: int) -> str:
    return f"round_{next_round:08d}.ckpt"


def _checkpoint_names(directory: str) -> list[str]:
    try:
        entries = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(e for e in entries if _CKPT_RE.match(e))


def latest_checkpoint(directory: str) -> str | None:
    """Path of the newest checkpoint in ``directory`` (the highest round),
    or ``None`` when there is none or no such directory."""
    hits = _checkpoint_names(directory)
    return os.path.join(directory, hits[-1]) if hits else None


def checkpoint_paths(directory: str) -> list[str]:
    """Every checkpoint path in ``directory``, newest first: the order in
    which ``make_engine(resume=directory)`` falls back when the newest file
    is truncated or corrupt."""
    return [os.path.join(directory, e) for e in reversed(_checkpoint_names(directory))]


@dataclass(frozen=True)
class CheckpointPolicy:
    """Declarative save schedule.

    - ``every_rounds``: save after round ``rnd`` when ``(rnd + 1) %
      every_rounds == 0`` (absolute cadence); ``None`` disables it.
    - ``every_seconds``: also save when at least this much wall time has
      passed since the last save; ``None`` disables it.
    - ``keep_last``: prune to the newest k files after each save; ``None``
      keeps everything.
    """

    every_rounds: int | None = 1
    every_seconds: float | None = None
    keep_last: int | None = None

    def __post_init__(self) -> None:
        if self.every_rounds is not None and self.every_rounds < 1:
            raise ValueError(f"every_rounds must be >= 1, got {self.every_rounds}")
        if self.every_seconds is not None and self.every_seconds <= 0:
            raise ValueError(f"every_seconds must be > 0, got {self.every_seconds}")
        if self.keep_last is not None and self.keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {self.keep_last}")
        if self.every_rounds is None and self.every_seconds is None:
            raise ValueError("policy has no trigger: set every_rounds or every_seconds")

    def round_due(self, rnd: int) -> bool:
        return self.every_rounds is not None and (rnd + 1) % self.every_rounds == 0

    def time_due(self, elapsed: float) -> bool:
        return self.every_seconds is not None and elapsed >= self.every_seconds


class Checkpointer:
    """A :class:`CheckpointPolicy` bound to a directory; ``clock`` is
    injectable for tests (default ``time.monotonic``)."""

    def __init__(self, directory: str, policy: CheckpointPolicy | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.directory = directory
        self.policy = policy or CheckpointPolicy()
        self._clock = clock
        self._last_save_t = clock()
        os.makedirs(directory, exist_ok=True)

    def round_due(self, rnd: int) -> bool:
        """True iff the *round* trigger fires after round ``rnd`` (the fused
        backend aligns its chunks with it; a time trigger cannot be
        predicted inside a chunk)."""
        return self.policy.round_due(rnd)

    def due(self, rnd: int) -> bool:
        return self.round_due(rnd) or self.policy.time_due(self._clock() - self._last_save_t)

    def save(self, engine) -> str:
        """Save the engine's committed state, whatever the policy says."""
        path = os.path.join(self.directory, _ckpt_name(engine._round))
        engine.save(path)
        self._last_save_t = self._clock()
        self._prune()
        return path

    def maybe_save(self, engine, rnd: int) -> str | None:
        """Save iff the policy says a save is due after round ``rnd``."""
        return self.save(engine) if self.due(rnd) else None

    def latest(self) -> str | None:
        return latest_checkpoint(self.directory)

    def _prune(self) -> None:
        k = self.policy.keep_last
        if k is None:
            return
        for stale in _checkpoint_names(self.directory)[:-k]:
            os.remove(os.path.join(self.directory, stale))
