"""repro_torch.engine — the federated engine API of the port.

- ``config``      — ``FLConfig``, field for field the reference's, with
                    validation that rejects what the port lacks;
                    ``SystemsConfig`` (``repro_torch.systems``) and
                    ``FaultConfig`` (``repro_torch.faults``) are its
                    systems and fault axes, ``PopulationConfig``
                    (``repro_torch.population``) its population axis
- ``registry``    — strategy / aggregator / client-mode / task / preset
                    registries
- ``base``        — ``Engine`` round protocol, ``RoundResult`` and
                    ``rounds_to_accuracy``
- ``host``        — ``HostEngine``: numpy selection + cohort training on
                    the device
- ``compiled``    — ``CompiledEngine``: mask selection, cohort gather,
                    training and aggregation on the device, read once a
                    round (``backend="compiled"``)
- ``fused``       — ``FusedEngine``: chunks of compiled rounds, each
                    length captured once as a CUDA graph on the card
                    (``fuse_rounds > 0``)
- ``scaleout``    — ``ScaleoutEngine``: the clients blocked over the pods
                    of a ``repro_torch.launch.mesh.Mesh`` (processes of
                    a ``torch.distributed`` group), every client trains,
                    the mask-weighted K1 sum over each process's block
                    meets in an all-reduce (``backend="scaleout"``); and
                    ``make_scaleout_round``, the transformer round
- ``async_config``— ``AsyncConfig`` (``FLConfig.async_mode``), the
                    staleness discounts and weights
- ``async_engine``— ``AsyncHostEngine`` / ``AsyncCompiledEngine``:
                    FedBuff-style buffered aggregation on the host or
                    compiled hooks, K1 over the kept deltas
- ``aggregators`` — ``fedavg``, ``fednova``, ``feddyn`` (the FedAvg reduce
                    kernel), ``trimmed_mean``, ``coordinate_median``
- ``client_modes``— ``plain``, ``fedprox``, ``feddyn``
- ``presets``     — the paper's named methods (``get_preset``)
- ``tasks``       — ``ClassificationTask`` (the paper's MLP) and ``LMTask``
                    (federated language modelling on a transformer)
- ``draws``       — ``TorchDraws``, the one source of randomness
- ``registry``    — also ``mask_selection_strategies`` and
                    ``traced_selection_strategies``, the strategies the
                    compiled backend and the fused mode run

Typical use::

    from repro_torch.data import make_classification
    from repro_torch.engine import FLConfig, make_engine

    engine = make_engine(FLConfig(rounds=5), train, test, n_classes=10)
    for result in engine.rounds():
        ...

Checkpointing and the async runtime (``repro_torch.checkpoint``)::

    cfg = FLConfig(systems={"profile": "mobile_mix"},
                   async_mode={"buffer_k": 5, "concurrency": 20,
                               "staleness": "polynomial"})
    engine = make_engine(cfg, train, test, 10, checkpointer="ckpt/",
                         tracker=JsonlTracker("metrics.jsonl"))
    ...  # killed
    engine = make_engine(cfg, train, test, 10, resume="ckpt/")
"""

from __future__ import annotations

import os
import warnings
from typing import Any

import torch

from repro_torch.checkpoint import (
    CheckpointError,
    CheckpointPolicy,
    Checkpointer,
    JsonlTracker,
    MetricsTracker,
    checkpoint_paths,
)
from repro_torch.engine.async_config import AsyncConfig
from repro_torch.engine.async_engine import AsyncCompiledEngine, AsyncHostEngine
from repro_torch.engine.base import Engine, MaskSelectionMixin, RoundResult, rounds_to_accuracy
from repro_torch.engine.compiled import CompiledEngine
from repro_torch.engine.config import BACKENDS, FLConfig
from repro_torch.engine.fused import FusedEngine
from repro_torch.engine.host import HostEngine
from repro_torch.engine.scaleout import ScaleoutEngine, make_scaleout_round
from repro_torch.engine.presets import (
    ExperimentPreset,
    get_preset,
    list_presets,
    register_preset,
)
from repro_torch.engine.registry import (
    AGGREGATOR_REGISTRY,
    CLIENT_MODE_REGISTRY,
    PRESET_REGISTRY,
    STRATEGY_REGISTRY,
    TASK_REGISTRY,
    Registry,
    list_aggregators,
    list_client_modes,
    list_strategies,
    list_tasks,
    mask_selection_strategies,
    register_aggregator,
    register_client_mode,
    register_strategy,
    register_task,
    traced_selection_strategies,
)
from repro_torch.engine.tasks import Task, build_task
from repro_torch.faults.config import FaultConfig
from repro_torch.population.config import PopulationConfig
from repro_torch.systems.config import SystemsConfig

__all__ = [
    "BACKENDS",
    "FLConfig",
    "SystemsConfig",
    "FaultConfig",
    "PopulationConfig",
    "Registry",
    "STRATEGY_REGISTRY",
    "AGGREGATOR_REGISTRY",
    "CLIENT_MODE_REGISTRY",
    "TASK_REGISTRY",
    "PRESET_REGISTRY",
    "register_strategy",
    "register_aggregator",
    "register_client_mode",
    "register_task",
    "list_strategies",
    "list_aggregators",
    "list_client_modes",
    "list_tasks",
    "Task",
    "build_task",
    "Engine",
    "MaskSelectionMixin",
    "RoundResult",
    "mask_selection_strategies",
    "traced_selection_strategies",
    "rounds_to_accuracy",
    "HostEngine",
    "CompiledEngine",
    "FusedEngine",
    "ScaleoutEngine",
    "make_scaleout_round",
    "ExperimentPreset",
    "get_preset",
    "list_presets",
    "register_preset",
    "make_engine",
    "AsyncConfig",
    "AsyncHostEngine",
    "AsyncCompiledEngine",
    "CheckpointPolicy",
    "Checkpointer",
    "JsonlTracker",
    "MetricsTracker",
]


def make_engine(cfg: FLConfig, train, test, n_classes: int, *,
                device: str | torch.device = "cuda", draws: Any = None,
                partition_labels=None, cohort_gather: bool = True, mesh=None,
                resume: str | None = None, checkpointer: Checkpointer | str | None = None,
                tracker: MetricsTracker | list | None = None):
    """Build the engine for ``cfg`` on ``device`` (default ``"cuda"``; raises
    without a card unless the caller passes ``"cpu"``): ``HostEngine`` for
    ``backend="host"``, ``CompiledEngine`` for ``"compiled"``,
    ``FusedEngine`` for ``"compiled"`` with ``fuse_rounds > 0``,
    ``ScaleoutEngine`` for ``"scaleout"`` (``mesh=``: a
    ``repro_torch.launch.mesh.Mesh`` with a ``pod`` axis in place of the
    default, one pod a process of the default process group), and
    ``AsyncHostEngine`` / ``AsyncCompiledEngine`` with ``cfg.async_mode``.
    ``train``/``test`` are the task's datasets (features and labels for
    ``task="classification"``, token and next-token sequences for
    ``task="lm"``); ``n_classes`` is the label cardinality (the vocab size
    for LM).  ``draws`` replaces the default ``TorchDraws`` (see
    ``repro_torch.engine.draws``); ``partition_labels`` is a (N,) integer
    array the non-IID partitioner splits on instead of the task's derived
    labels.  ``cohort_gather=False`` (compiled only; fused chunks always
    gather, the async runtime refuses it) trains every client and gates
    the aggregation with the mask, the reference's legacy path.

    Checkpointing and observability:

    - ``resume=``       — a checkpoint written by ``Engine.save``, or a
      directory of them, walked newest first: a truncated or corrupt file
      (``CheckpointError``) falls back to the next with a warning; a
      config or structure mismatch stays fatal, and an empty directory
      fails.  The engine restores before it is returned, so ``rounds()``
      continues the run.
    - ``checkpointer=`` — a ``Checkpointer`` (or a directory, which gets the
      every-round default policy), consulted after every committed round.
    - ``tracker=``      — a ``MetricsTracker`` (or a list of them) added to
      ``engine.trackers``; every streamed ``RoundResult`` is logged."""
    kw = dict(device=device, draws=draws, partition_labels=partition_labels)
    if cfg.backend != "compiled" and not cohort_gather:
        raise ValueError("cohort_gather=False applies to backend='compiled'")
    if mesh is not None and cfg.backend != "scaleout":
        raise ValueError("mesh= applies to backend='scaleout'")
    if cfg.async_mode is not None:
        if cfg.backend == "compiled":
            engine = AsyncCompiledEngine(cfg, train, test, n_classes,
                                         cohort_gather=cohort_gather, **kw)
        else:
            engine = AsyncHostEngine(cfg, train, test, n_classes, **kw)
    elif cfg.backend == "host":
        engine = HostEngine(cfg, train, test, n_classes, **kw)
    elif cfg.backend == "scaleout":
        engine = ScaleoutEngine(cfg, train, test, n_classes, mesh=mesh, **kw)
    elif cfg.fuse_rounds > 0:
        engine = FusedEngine(cfg, train, test, n_classes, **kw)
    else:
        engine = CompiledEngine(cfg, train, test, n_classes, cohort_gather=cohort_gather, **kw)
    if checkpointer is not None:
        engine.checkpointer = (Checkpointer(checkpointer) if isinstance(checkpointer, str)
                               else checkpointer)
    if tracker is not None:
        engine.trackers.extend(tracker if isinstance(tracker, (list, tuple)) else [tracker])
    if resume is not None:
        _resume(engine, resume)
    return engine


def _resume(engine, path: str) -> None:
    """Restore ``path`` into ``engine``; a directory is walked newest
    first, falling back past corrupt files."""
    if not os.path.isdir(path):
        engine.restore(path)
        return
    candidates = checkpoint_paths(path)
    if not candidates:
        raise FileNotFoundError(f"resume directory {path!r} holds no round_*.ckpt files")
    for i, cand in enumerate(candidates):
        try:
            engine.restore(cand)
            return
        except CheckpointError as e:
            if i == len(candidates) - 1:
                raise CheckpointError(f"no valid checkpoint in {path!r} — every round_*.ckpt "
                                      f"file is corrupt (last error: {e})") from e
            warnings.warn(f"skipping corrupt checkpoint {cand!r} ({e}); falling back to "
                          f"{candidates[i + 1]!r}", stacklevel=3)
