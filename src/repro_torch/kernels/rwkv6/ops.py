"""Wrapper of the WKV6 kernel (csrc/wkv6.cu).

On CUDA tensors it launches the hand-written kernel, or raises if the
kernel does not take the inputs; on CPU tensors it runs the plain
version :func:`.ref.wkv6_ref`. No fallback between the two.

Where a gradient is needed (grad mode on, an input requiring one) the
call goes through :class:`WKV6`, the counterpart of the reference's
``custom_vjp`` (``kernels/rwkv6/ops.py``): its forward is the same
launch, its backward the VJP of the plain version, recomputed from the
saved inputs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._attn import DTYPES
from repro_torch.kernels.rwkv6.ref import wkv6_ref

HEAD_SIZES = (32, 64)


def _check(r, k, v, logw, u, s0, sT) -> None:
    """What the kernel takes: r, k, v (B,S,H,hd) of one dtype (bf16 or
    float32), logw (B,S,H,hd) float32, each last dim contiguous; u (H,hd)
    float32 contiguous; s0 and sT (B,H,hd,hd) float32 with each head's
    (hd,hd) state contiguous; hd in ``HEAD_SIZES``; S >= 1; all on the
    current CUDA device."""
    if r.dim() != 4:
        raise ValueError(f"wkv6: r must be (B, S, H, hd), got "
                         f"{tuple(r.shape)}")
    B, S, H, hd = r.shape
    for what, t in (("k", k), ("v", v), ("logw", logw)):
        if t.shape != r.shape:
            raise ValueError(f"wkv6: {what} {tuple(t.shape)} differs from r "
                             f"{tuple(r.shape)}")
    if u.shape != (H, hd) or s0.shape != (B, H, hd, hd) \
            or sT.shape != s0.shape:
        raise ValueError(f"wkv6: u {tuple(u.shape)} / s0 {tuple(s0.shape)} "
                         f"do not match r {tuple(r.shape)}")
    if hd not in HEAD_SIZES:
        raise ValueError(f"wkv6: no kernel for head size {hd}; compiled for "
                         f"{HEAD_SIZES}")
    if S == 0:
        raise ValueError("wkv6: empty sequence")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6: r, k, v must share one dtype of "
                        f"{sorted(map(str, DTYPES))}, got {r.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    for what, t in (("logw", logw), ("u", u), ("s0", s0), ("sT", sT)):
        if t.dtype != torch.float32:
            raise TypeError(f"wkv6: {what} must be float32, got {t.dtype}")
    tensors = (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u),
               ("s0", s0), ("sT", sT))
    for what, t in tensors:
        if t.stride(-1) != 1:
            raise ValueError(f"wkv6: {what}'s last dim must be contiguous "
                             f"(strides {t.stride()})")
    if not u.is_contiguous():
        raise ValueError("wkv6: u must be contiguous")
    for what, t in (("s0", s0), ("sT", sT)):
        if t.stride(2) != hd:
            raise ValueError(f"wkv6: each head's state in {what} must be "
                             f"contiguous (strides {t.stride()})")
    for what, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"wkv6: {what} on {t.device}, expected a CUDA "
                             "tensor")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(f"wkv6: {what} on {t.device}, but the current "
                             f"CUDA device is {torch.cuda.current_device()}")


def _forward(r, k, v, logw, u, s0, inplace):
    """The kernel (CUDA) or the plain version (CPU), no autograd."""
    if r.device.type == "cpu":
        y, sT = wkv6_ref(r, k, v, logw, u, s0)
        if inplace:
            sT = s0.copy_(sT)
        return y, sT
    B, S, H, hd = r.shape
    sT = s0 if inplace else torch.empty((B, H, hd, hd), dtype=torch.float32,
                                        device=r.device)
    _check(r, k, v, logw, u, s0, sT)
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    vals = [st for t in (r, k, v, logw, y) for st in t.stride()[:3]]
    vals += [s0.stride(0), s0.stride(1), sT.stride(0), sT.stride(1)]
    strides = (ctypes.c_int64 * len(vals))(*vals)
    rc = _build.load("wkv6").wkv6_launch(
        DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        logw.data_ptr(), u.data_ptr(), s0.data_ptr(), sT.data_ptr(),
        y.data_ptr(), B, S, H, hd, strides,
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "wkv6")
    return y, sT


class WKV6(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU), returning
    (y, sT). Backward: the gradients of :func:`.ref.wkv6_ref` at the
    saved inputs, as the reference's ``_wkv_b``; a None (unused) or zero
    gradient of sT is taken as it is."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, logw, u, s0)
        return _forward(r, k, v, logw, u, s0, False)

    @staticmethod
    def backward(ctx, gy, gs):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            outs = wkv6_ref(*ins)
            pairs = [(o, g) for o, g in zip(outs, (gy, gs)) if g is not None]
            if not pairs:
                return (None,) * 6
            grads = torch.autograd.grad([o for o, _ in pairs], ins,
                                        [g for _, g in pairs],
                                        allow_unused=True)
        return tuple(grads)


def wkv6(r, k, v, logw, u, s0, *, inplace: bool = False):
    """r,k,v: (B,S,H,hd) bf16 or float32; logw: (B,S,H,hd) float32 (the
    log decay, < 0); u: (H,hd) float32; s0: (B,H,hd,hd) float32. Returns
    (y (B,S,H,hd) float32, sT (B,H,hd,hd) float32), the function of
    :func:`.ref.wkv6_ref`, for any S >= 1.

    ``inplace=True`` writes the final state over ``s0`` and returns s0
    as sT: the serving path hands the slots' rows of the ``wkv`` cache
    and keeps them. The kernel can, since each (b, h) block reads its
    state once before it writes it; on the CPU the plain version's sT is
    copied into s0.

    Differentiable in every input (:class:`WKV6`) when not ``inplace``;
    a call that needs a gradient and asks for ``inplace`` raises."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, logw, u, s0)):
        if inplace:
            raise ValueError("wkv6: inplace=True writes s0, which a call "
                             "that needs a gradient keeps")
        return WKV6.apply(r, k, v, logw, u, s0)
    return _forward(r, k, v, logw, u, s0, inplace)
