"""Client-side training and server-side aggregation of the port:
``client`` (local SGD of a cohort), ``aggregation`` (the server rules),
``compression`` (quantized uploads) and ``scaleout`` (the transformer
round over the pods of a mesh; its engine entry points are
``repro_torch.engine.scaleout.ScaleoutEngine`` and
``make_scaleout_round``).

``FLConfig`` is ``repro_torch.engine.FLConfig``, as the reference's
``repro.federated.FLConfig`` is its engine's."""

__all__ = ["FLConfig"]


def __getattr__(name):
    if name == "FLConfig":
        from repro_torch.engine import FLConfig

        return FLConfig
    raise AttributeError(f"module 'repro_torch.federated' has no attribute {name!r}")
