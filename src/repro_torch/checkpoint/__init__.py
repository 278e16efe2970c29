"""Checkpointing of the port, ported from ``repro.checkpoint``: a format of
its own (magic + JSON header + raw little-endian array bytes; no msgpack,
no pickle), save policies and the metrics-tracker seam.

- ``serializer`` — atomic, fsync-durable save and load of a tree of
  tensors and numpy arrays, with loud dtype / shape / structure checks.
- ``policy``     — ``CheckpointPolicy`` (every N rounds / every T seconds /
  keep the last k) and ``Checkpointer``, driven from ``engine.rounds()``.
- ``tracker``    — ``MetricsTracker``; ``JsonlTracker`` lands every
  streamed ``RoundResult`` durably.
"""

from repro_torch.checkpoint.policy import (
    CheckpointPolicy,
    Checkpointer,
    checkpoint_paths,
    latest_checkpoint,
)
from repro_torch.checkpoint.serializer import (
    CheckpointError,
    load_checkpoint,
    load_meta,
    save_checkpoint,
)
from repro_torch.checkpoint.tracker import JsonlTracker, MetricsTracker, read_jsonl

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "load_meta",
    "CheckpointError",
    "CheckpointPolicy",
    "Checkpointer",
    "latest_checkpoint",
    "checkpoint_paths",
    "MetricsTracker",
    "JsonlTracker",
    "read_jsonl",
]
