"""Device resolution and numeric settings shared by the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "pin_fp32_matmul"]


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    card is present (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cuda' or 'cpu'; got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the port on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def pin_fp32_matmul() -> None:
    """Full-fp32 matrix products: no TF32 in cuBLAS or cuDNN.  The JAX
    reference multiplies in full fp32, and the Hellinger and loss values
    the selection ranks are compared against it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
