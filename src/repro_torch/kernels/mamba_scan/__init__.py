from repro_torch.kernels.mamba_scan.ops import (
    mamba_scan,
    mamba_scan_backward,
    mamba_scan_forward,
)
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

__all__ = ["mamba_scan", "mamba_scan_forward", "mamba_scan_backward", "mamba_scan_ref"]
