"""Plain PyTorch version of the counter bump: the CPU path, and the
yardstick the CUDA kernel (csrc/counter_bump.cu) is held to."""
from __future__ import annotations


def counter_bump_ref(sig, upd):
    """int32 ``sig + upd``, a new tensor."""
    return sig + upd
