from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_attention_backward,
    flash_attention_forward,
)
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "flash_attention_forward", "flash_attention_backward",
           "attention_ref"]
