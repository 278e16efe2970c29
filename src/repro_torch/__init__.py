"""repro_torch — the PyTorch/CUDA port of the FedLECC system in ``repro``.

The JAX package ``repro`` is the reference; this package re-implements it
for one NVIDIA H100 and imports neither JAX nor ``repro``.  Module names
mirror the reference (``engine``, ``data``, ``core``, ``models``,
``federated``); the TPU kernels become hand-written CUDA kernels under
``csrc/``, bound through ``kernels``.

Entry points (``engine.make_engine``, ``engine.Engine``, and the
functions that take numpy inputs and a ``device=``) default to
``device="cuda"`` and raise when no card is present; pass
``device="cpu"`` to run on the CPU, where every kernel wrapper takes its
plain PyTorch version.
"""
