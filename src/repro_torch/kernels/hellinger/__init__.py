from repro_torch.kernels.hellinger.ops import hellinger_strip
from repro_torch.kernels.hellinger.ref import hellinger_strip_ref

__all__ = ["hellinger_strip", "hellinger_strip_ref"]
