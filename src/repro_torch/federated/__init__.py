"""Client-side training and server-side aggregation of the port:
``client`` (local SGD of a cohort), ``aggregation`` (the server rules),
``compression`` (quantized uploads) and ``scaleout`` (the transformer
round over the pods of a mesh; its engine entry points are
``repro_torch.engine.scaleout.ScaleoutEngine`` and
``make_scaleout_round``).

``simulation`` is the deprecated shim ``FederatedSimulation`` over
``repro_torch.engine.host.HostEngine``.  ``FLConfig`` and
``FederatedSimulation`` are lazy re-exports (PEP 562), as in the
reference, so importing a submodule never pulls in the engine stack."""

__all__ = ["FLConfig", "FederatedSimulation"]


def __getattr__(name):
    if name in __all__:
        from repro_torch.federated import simulation

        return getattr(simulation, name)
    raise AttributeError(f"module 'repro_torch.federated' has no attribute {name!r}")
