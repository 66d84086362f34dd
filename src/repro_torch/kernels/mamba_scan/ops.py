"""Wrapper of the selective-scan kernel (csrc/mamba_scan.cu).

On CUDA tensors it launches the hand-written kernel, or raises if the
kernel does not take the inputs; on CPU tensors it runs the plain
version :func:`.ref.mamba_scan_ref`. No fallback between the two.

Where a gradient is needed (grad mode on, an input requiring one) the
call goes through :class:`MambaScan`, the counterpart of the
reference's ``custom_vjp`` (``kernels/mamba_scan/ops.py``): its forward
is the same launch, its backward the VJP of the plain version,
recomputed from the saved inputs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._attn import DTYPES
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

STATE_SIZES = (8, 16)


def _check(a_log, dt, b, c, xc, h0, hT) -> None:
    """What the kernel takes: dt, xc (B,S,di) and b, c (B,S,ds) of one
    dtype (bf16 or float32), each last dim contiguous (b and c may be
    column slices of one wider tensor); a_log (di,ds) float32
    contiguous; h0 and hT (B,di,ds) float32 with each sequence's
    (di,ds) state contiguous; ds in ``STATE_SIZES``; S >= 1; all on the
    current CUDA device."""
    if dt.dim() != 3 or a_log.dim() != 2:
        raise ValueError(f"mamba_scan: dt must be (B, S, di) and a_log "
                         f"(di, ds), got {tuple(dt.shape)}, "
                         f"{tuple(a_log.shape)}")
    B, S, di = dt.shape
    ds = a_log.shape[1]
    if xc.shape != dt.shape or a_log.shape[0] != di:
        raise ValueError(f"mamba_scan: xc {tuple(xc.shape)} / a_log "
                         f"{tuple(a_log.shape)} do not match dt "
                         f"{tuple(dt.shape)}")
    for what, t in (("b", b), ("c", c)):
        if t.shape != (B, S, ds):
            raise ValueError(f"mamba_scan: {what} {tuple(t.shape)}, "
                             f"expected {(B, S, ds)}")
    for what, t in (("h0", h0), ("hT", hT)):
        if t.shape != (B, di, ds):
            raise ValueError(f"mamba_scan: {what} {tuple(t.shape)}, "
                             f"expected {(B, di, ds)}")
    if ds not in STATE_SIZES:
        raise ValueError(f"mamba_scan: no kernel for state size {ds}; "
                         f"compiled for {STATE_SIZES}")
    if S == 0:
        raise ValueError("mamba_scan: empty sequence")
    if xc.dtype not in DTYPES or any(t.dtype != xc.dtype
                                     for t in (dt, b, c)):
        raise TypeError(f"mamba_scan: dt, b, c, xc must share one dtype "
                        f"of {sorted(map(str, DTYPES))}, got {dt.dtype}, "
                        f"{b.dtype}, {c.dtype}, {xc.dtype}")
    for what, t in (("a_log", a_log), ("h0", h0), ("hT", hT)):
        if t.dtype != torch.float32:
            raise TypeError(f"mamba_scan: {what} must be float32, got "
                            f"{t.dtype}")
    tensors = (("a_log", a_log), ("dt", dt), ("b", b), ("c", c),
               ("xc", xc), ("h0", h0), ("hT", hT))
    for what, t in tensors:
        if t.stride(-1) != 1:
            raise ValueError(f"mamba_scan: {what}'s last dim must be "
                             f"contiguous (strides {t.stride()})")
    if not a_log.is_contiguous():
        raise ValueError("mamba_scan: a_log must be contiguous")
    for what, t in (("h0", h0), ("hT", hT)):
        if t.stride(1) != ds:
            raise ValueError(f"mamba_scan: each sequence's state in {what} "
                             f"must be contiguous (strides {t.stride()})")
    for what, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"mamba_scan: {what} on {t.device}, expected "
                             "a CUDA tensor")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(f"mamba_scan: {what} on {t.device}, but the "
                             "current CUDA device is "
                             f"{torch.cuda.current_device()}")


def _forward(a_log, dt, b, c, xc, h0, inplace):
    """The kernel (CUDA) or the plain version (CPU), no autograd."""
    if dt.device.type == "cpu":
        y, hT = mamba_scan_ref(a_log, dt, b, c, xc, h0)
        if inplace:
            hT = h0.copy_(hT)
        return y, hT
    B, S, di = dt.shape
    ds = a_log.shape[-1]
    hT = h0 if inplace else torch.empty((B, di, ds), dtype=torch.float32,
                                        device=dt.device)
    _check(a_log, dt, b, c, xc, h0, hT)
    y = torch.empty((B, S, di), dtype=xc.dtype, device=dt.device)
    vals = [st for t in (dt, b, c, xc) for st in t.stride()[:2]]
    vals += [h0.stride(0), hT.stride(0)]
    strides = (ctypes.c_int64 * len(vals))(*vals)
    rc = _build.load("mamba_scan").mamba_scan_launch(
        DTYPES[xc.dtype], ds, a_log.data_ptr(), dt.data_ptr(), b.data_ptr(),
        c.data_ptr(), xc.data_ptr(), h0.data_ptr(), hT.data_ptr(),
        y.data_ptr(), B, S, di, strides,
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mamba_scan")
    return y, hT


class MambaScan(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU), returning
    (y, hT). Backward: the gradients of :func:`.ref.mamba_scan_ref` at
    the saved inputs, as the reference's ``_ms_b``; a None (unused) or
    zero gradient of hT is taken as it is."""

    @staticmethod
    def forward(ctx, a_log, dt, b, c, xc, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(a_log, dt, b, c, xc, h0)
        return _forward(a_log, dt, b, c, xc, h0, False)

    @staticmethod
    def backward(ctx, gy, gh):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            outs = mamba_scan_ref(*ins)
            pairs = [(o, g) for o, g in zip(outs, (gy, gh)) if g is not None]
            if not pairs:
                return (None,) * 6
            grads = torch.autograd.grad([o for o, _ in pairs], ins,
                                        [g for _, g in pairs],
                                        allow_unused=True)
        return tuple(grads)


def mamba_scan(a_log, dt, b, c, xc, h0, *, inplace: bool = False):
    """a_log: (di,ds) float32; dt, xc: (B,S,di) and b, c: (B,S,ds), bf16
    or float32; h0: (B,di,ds) float32. Returns (y (B,S,di) in xc's
    dtype, hT (B,di,ds) float32), the function of
    :func:`.ref.mamba_scan_ref`, for any S >= 1.

    ``inplace=True`` writes the final state over ``h0`` and returns h0
    as hT: the serving path hands the slots' rows of the ``ssm`` cache
    and keeps them. The kernel can, since each thread reads its (b, d)
    state row once before it writes it; on the CPU the plain version's
    hT is copied into h0.

    Differentiable in every input (:class:`MambaScan`) when not
    ``inplace``; a call that needs a gradient and asks for ``inplace``
    raises."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (a_log, dt, b, c, xc, h0)):
        if inplace:
            raise ValueError("mamba_scan: inplace=True writes h0, which a "
                             "call that needs a gradient keeps")
        return MambaScan.apply(a_log, dt, b, c, xc, h0)
    return _forward(a_log, dt, b, c, xc, h0, inplace)
