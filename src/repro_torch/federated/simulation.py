"""Deprecated entry point, ported from ``repro.federated.simulation``: the
simulation lives in ``repro_torch.engine``.

``FederatedSimulation`` is a thin shim over
``repro_torch.engine.host.HostEngine``: the same constructor (with the
port's keyword arguments, ``device=`` among them: the card unless the
caller asks for ``"cpu"``), the same attributes, and ``run()`` returns the
same history dict.  New code should use::

    from repro_torch.engine import FLConfig, make_engine

    engine = make_engine(FLConfig(backend="host", ...), train, test, n_classes)
    for result in engine.rounds():   # RoundResult stream
        ...

``FLConfig`` and ``rounds_to_accuracy`` are re-exported here, as in the
reference.
"""

from __future__ import annotations

import warnings

from repro_torch.engine.base import rounds_to_accuracy
from repro_torch.engine.config import FLConfig
from repro_torch.engine.host import HostEngine

__all__ = ["FLConfig", "FederatedSimulation", "rounds_to_accuracy"]


class FederatedSimulation(HostEngine):
    """Deprecated alias of :class:`repro_torch.engine.host.HostEngine`."""

    def __init__(self, cfg: FLConfig, train, test, n_classes: int, **kwargs):
        warnings.warn(
            "FederatedSimulation is deprecated; use repro.engine.make_engine"
            " (engine.rounds() streams RoundResult records; engine.run()"
            " returns the same history dict)",
            DeprecationWarning,
            stacklevel=2,
        )
        super().__init__(cfg, train, test, n_classes, **kwargs)
