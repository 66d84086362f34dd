from repro_torch.kernels.norm_rope.ops import DTYPES, rmsnorm, rope_cache
from repro_torch.kernels.norm_rope.ref import (rmsnorm_ref, rope_cache_ref,
                                               rope_ref)

__all__ = ["DTYPES", "rmsnorm", "rmsnorm_ref", "rope_cache",
           "rope_cache_ref", "rope_ref"]
