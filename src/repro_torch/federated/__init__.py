"""Client-side training and server-side aggregation of the port.

``FLConfig`` is ``repro_torch.engine.FLConfig``, as the reference's
``repro.federated.FLConfig`` is its engine's."""

__all__ = ["FLConfig"]


def __getattr__(name):
    if name == "FLConfig":
        from repro_torch.engine import FLConfig

        return FLConfig
    raise AttributeError(f"module 'repro_torch.federated' has no attribute {name!r}")
