"""Window dtype names: numpy's names ("float32", "int32"), plus
"bfloat16", which numpy lacks and the JAX package spells the same way
(ml_dtypes registers it with numpy there). Lowering sizes payloads from
these names, so a bf16 window lowers exactly as the reference's does."""
from __future__ import annotations

import numpy as np

_NOT_IN_NUMPY = {"bfloat16": 2}


def dtype_name(dtype) -> str:
    """Canonical name of a window dtype."""
    if isinstance(dtype, str) and dtype in _NOT_IN_NUMPY:
        return dtype
    return np.dtype(dtype).name


def dtype_size(dtype) -> int:
    """Bytes per element of a window dtype."""
    if isinstance(dtype, str) and dtype in _NOT_IN_NUMPY:
        return _NOT_IN_NUMPY[dtype]
    return np.dtype(dtype).itemsize
