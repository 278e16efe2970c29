from repro_torch.kernels.aggregate.ops import masked_weighted_sum
from repro_torch.kernels.aggregate.ref import masked_weighted_sum_ref

__all__ = ["masked_weighted_sum", "masked_weighted_sum_ref"]
