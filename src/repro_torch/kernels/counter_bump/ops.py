"""Wrappers of the counter-bump kernels (csrc/counter_bump.cu).

On a CUDA tensor each launches its hand-written kernel (or raises); on a
CPU tensor it runs its plain version from :mod:`.ref`. No fallback
between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.counter_bump.ref import (counter_bump_ref,
                                                  put_multicast_ref,
                                                  put_signal_ref)

# the kernel lists, per payload row, the (branch, dst) pairs it feeds in
# 48 KB of shared memory: nb * R + nb ints
MULTICAST_TABLE_INTS = 48 * 1024 // 4


def _check_counters(sig, upd, what):
    if sig.shape != upd.shape:
        raise ValueError(f"{what}: shapes {tuple(sig.shape)} and "
                         f"{tuple(upd.shape)} differ")
    if sig.dtype != torch.int32 or upd.dtype != torch.int32:
        raise TypeError(f"{what}: counters are int32, got "
                        f"{sig.dtype} and {upd.dtype}")
    if upd.device != sig.device:
        raise ValueError(f"{what}: upd on {upd.device}, sig on "
                         f"{sig.device}")


def _check_launch(t, what):
    """A CUDA tensor on the current device (the kernel launches there)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for a tensor on {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{what}: on {t.device}, but the current "
                         f"CUDA device is {torch.cuda.current_device()}")


def rank_rows(x: torch.Tensor):
    """``x`` (R, ...) viewed as (R, s) rows, one per rank, without a copy,
    or None where a rank's ``s`` elements are not contiguous (the rank
    stride is free)."""
    R = x.shape[0]
    s = x.numel() // R if R else 0
    try:
        rows = x.view(R, s)
    except RuntimeError:
        return None
    return rows if s <= 1 or rows.stride(1) == 1 else None


def counter_bump(sig: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """New int32 tensor ``sig + upd`` (equal shapes, one device)."""
    _check_counters(sig, upd, "counter bump")
    if sig.device.type == "cpu":
        return counter_bump_ref(sig, upd)
    _check_launch(sig, "counter bump")
    if not (sig.is_contiguous() and upd.is_contiguous()):
        raise ValueError("counter bump: sig and upd must be contiguous")
    out = torch.empty_like(sig)
    rc = _build.load("counter_bump").counter_bump_launch(
        sig.data_ptr(), upd.data_ptr(), out.data_ptr(), sig.numel(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "counter_bump")
    return out


def _signal_args(sig, upd, dev, what):
    if (sig is None) != (upd is None):
        raise ValueError(f"{what}: give sig and upd together")
    if sig is not None:
        _check_counters(sig, upd, what)
        if sig.device != dev:
            raise ValueError(f"{what}: sig on {sig.device}, x on {dev}")


def _payload_rows(x, R, what):
    """(elements per rank, rank stride in elements) of a payload whose
    ranks' elements are each contiguous, else ValueError."""
    s = x.numel() // R if R else 0
    if x.is_contiguous():
        return s, s
    rows = rank_rows(x)
    if rows is None:
        raise ValueError(f"{what}: each rank's elements must be contiguous "
                         f"(shape {tuple(x.shape)}, strides {x.stride()})")
    return s, rows.stride(0)


def put_signal(x: torch.Tensor, perm: torch.Tensor, sig=None, upd=None):
    """A put with its completion signal in one launch.

    ``x`` is an (R, ...) payload whose ranks' elements are each
    contiguous (the rank stride is free); ``perm`` an (R,) int64 device
    table, ``perm[dst]`` the source rank of ``dst`` or -1 for none. Row
    ``dst`` of the new contiguous result is row ``perm[dst]`` of ``x``,
    zeros where -1. With ``sig``/``upd`` (int32, equal shapes) the same
    launch also writes the new counter buffer ``sig + upd`` and the call
    returns ``(result, counters)``. Any dtype: rows are copied as bytes.
    """
    # the Faces path calls this 26 times an iteration and is bound by the
    # host: each tensor property below is read once
    dev = x.device
    R = x.shape[0] if x.dim() else 0
    if x.dim() == 0 or perm.shape != (R,) or perm.dtype != torch.int64:
        raise ValueError(f"put_signal: perm must be ({R},) int64 for a "
                         f"payload of shape {tuple(x.shape)}, got "
                         f"{tuple(perm.shape)} {perm.dtype}")
    if perm.device != dev:
        raise ValueError(f"put_signal: perm on {perm.device}, x on {dev}")
    _signal_args(sig, upd, dev, "put_signal")
    if dev.type == "cpu":
        return put_signal_ref(x, perm, sig, upd)
    _check_launch(x, "put_signal")
    s, x_stride = _payload_rows(x, R, "put_signal")
    if not perm.is_contiguous():
        raise ValueError("put_signal: perm must be contiguous")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    new_sig, nsig = None, 0
    if sig is not None:
        if not (sig.is_contiguous() and upd.is_contiguous()):
            raise ValueError("put_signal: sig and upd must be contiguous")
        new_sig, nsig = torch.empty_like(sig), sig.numel()
    esize = x.element_size()
    rc = _build.load("counter_bump").put_signal_launch(
        x.data_ptr(), x_stride * esize, out.data_ptr(), s * esize,
        R, perm.data_ptr(),
        None if sig is None else sig.data_ptr(),
        None if sig is None else upd.data_ptr(),
        None if sig is None else new_sig.data_ptr(), nsig,
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "put_signal")
    return out if sig is None else (out, new_sig)


def put_multicast(x: torch.Tensor, perms: torch.Tensor, sig=None, upd=None):
    """A multicast put with its completion signal in one launch.

    ``x`` is an (R, ...) payload whose ranks' elements are each
    contiguous; ``perms`` an (nb, R) int64 device table, one row per
    branch, ``perms[b, dst]`` the source rank of ``dst`` in branch ``b``
    or -1 for none. Returns a tuple of ``nb`` new contiguous tensors
    shaped like ``x``: row ``dst`` of entry ``b`` is row ``perms[b, dst]``
    of ``x``, zeros where -1. With ``sig``/``upd`` the same launch also
    writes ``sig + upd`` and the call returns ``(outs, counters)``. Any
    dtype: rows are copied as bytes, the payload read once.
    """
    dev = x.device
    R = x.shape[0] if x.dim() else 0
    if (x.dim() == 0 or perms.dim() != 2 or perms.shape[1] != R
            or perms.shape[0] < 1 or perms.dtype != torch.int64):
        raise ValueError(f"put_multicast: perms must be (nb >= 1, {R}) "
                         f"int64 for a payload of shape {tuple(x.shape)}, "
                         f"got {tuple(perms.shape)} {perms.dtype}")
    if perms.device != dev:
        raise ValueError(f"put_multicast: perms on {perms.device}, x on "
                         f"{dev}")
    _signal_args(sig, upd, dev, "put_multicast")
    if dev.type == "cpu":
        return put_multicast_ref(x, perms, sig, upd)
    _check_launch(x, "put_multicast")
    nb = perms.shape[0]
    if nb * R + nb > MULTICAST_TABLE_INTS:
        raise ValueError(f"put_multicast: {nb} branches over {R} ranks "
                         f"exceed the kernel's table ({MULTICAST_TABLE_INTS}"
                         " ints of shared memory)")
    s, x_stride = _payload_rows(x, R, "put_multicast")
    if not perms.is_contiguous():
        raise ValueError("put_multicast: perms must be contiguous")
    out = torch.empty((nb,) + tuple(x.shape), dtype=x.dtype, device=dev)
    new_sig, nsig = None, 0
    if sig is not None:
        if not (sig.is_contiguous() and upd.is_contiguous()):
            raise ValueError("put_multicast: sig and upd must be "
                             "contiguous")
        new_sig, nsig = torch.empty_like(sig), sig.numel()
    esize = x.element_size()
    rc = _build.load("counter_bump").put_multicast_launch(
        x.data_ptr(), x_stride * esize, out.data_ptr(), s * esize,
        R, nb, perms.data_ptr(),
        None if sig is None else sig.data_ptr(),
        None if sig is None else upd.data_ptr(),
        None if sig is None else new_sig.data_ptr(), nsig,
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "put_multicast")
    outs = tuple(out.unbind(0))
    return outs if sig is None else (outs, new_sig)
