"""Wrapper of the counter-bump kernel (csrc/counter_bump.cu).

On a CUDA tensor it launches the hand-written kernel (or raises); on a
CPU tensor it runs :func:`.ref.counter_bump_ref`. No fallback between
the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.counter_bump.ref import counter_bump_ref


def counter_bump(sig: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """New int32 tensor ``sig + upd`` (equal shapes, one device)."""
    if sig.shape != upd.shape:
        raise ValueError(f"counter bump: shapes {tuple(sig.shape)} and "
                         f"{tuple(upd.shape)} differ")
    if sig.dtype != torch.int32 or upd.dtype != torch.int32:
        raise TypeError(f"counter bump: counters are int32, got "
                        f"{sig.dtype} and {upd.dtype}")
    if upd.device != sig.device:
        raise ValueError(f"counter bump: upd on {upd.device}, sig on "
                         f"{sig.device}")
    if sig.device.type == "cpu":
        return counter_bump_ref(sig, upd)
    if sig.device.type != "cuda":
        raise ValueError(f"counter bump: no kernel for a tensor on "
                         f"{sig.device}")
    if not (sig.is_contiguous() and upd.is_contiguous()):
        raise ValueError("counter bump: sig and upd must be contiguous")
    if sig.device.index != torch.cuda.current_device():
        raise ValueError(f"counter bump: on {sig.device}, but the current "
                         f"CUDA device is {torch.cuda.current_device()}")
    out = torch.empty_like(sig)
    rc = _build.load("counter_bump").counter_bump_launch(
        sig.data_ptr(), upd.data_ptr(), out.data_ptr(), sig.numel(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "counter_bump")
    return out
