from repro_torch.kernels.counter_bump.ops import counter_bump
from repro_torch.kernels.counter_bump.ref import counter_bump_ref

__all__ = ["counter_bump", "counter_bump_ref"]
