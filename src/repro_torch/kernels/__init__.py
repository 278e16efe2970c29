"""Hand-written Hopper kernels of the port, each beside its plain version.

- ``hellinger`` — the Hellinger strip (replaces the TPU kernel in
  ``repro/kernels/hellinger/kernel.py``), source ``csrc/hellinger_strip.cu``.
- ``aggregate`` — the FedAvg reduce (replaces the TPU kernel in
  ``repro/kernels/aggregate/kernel.py``), source ``csrc/fedavg_reduce.cu``.
- ``flash_attention`` — causal flash attention, forward and backward
  (replaces the TPU kernel in ``repro/kernels/flash_attention/kernel.py``),
  source ``csrc/flash_attention.cu``.
- ``mamba_scan`` — the Mamba selective scan, forward and backward (replaces
  the TPU kernel in ``repro/kernels/mamba_scan/kernel.py``), source
  ``csrc/mamba_scan.cu``.

A wrapper launches its CUDA kernel for CUDA tensors and takes the plain
PyTorch version (``ref.py``) only for CPU tensors.  Each wrapper counts its
kernel launches in its ``launches`` attribute.
"""
