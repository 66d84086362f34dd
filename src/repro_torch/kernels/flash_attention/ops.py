"""Wrapper of the flash attention kernel (csrc/flash_attention.cu).

On a CUDA tensor it launches the hand-written kernel, or raises if the
kernel does not take the inputs (:func:`.._attn.check_inputs`); on a CPU
tensor it runs the plain version :func:`.ref.flash_attention_ref`. No
fallback between the two.

Where a gradient is needed (grad mode on, q, k or v requiring one) the
call goes through :class:`FlashAttention`, the counterpart of the
reference's ``custom_vjp`` (``kernels/flash_attention/ops.py``): its
forward is the same launch, its backward the VJP of the plain version,
recomputed from the saved inputs. No backward kernel exists in the
reference either.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _attn, _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def _forward(q, k, v, q_offset, kvl, causal, scale=None):
    """The kernel (CUDA) or the plain version (CPU), no autograd;
    ``q_offset`` and ``kvl``: (B,) int32 (:func:`_norm_inputs`);
    ``scale`` None for the default, which the kernel computes itself
    (bit for bit the launches before the argument existed)."""
    B = q.shape[0]
    if scale is not None and not scale > 0:
        raise ValueError(f"flash attention: scale {scale} is not positive")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_offset=q_offset,
                                   kv_valid_len=kvl, causal=causal,
                                   scale=scale)
    _attn.check_inputs("flash attention", q, k, v, q_offset, kvl)
    _, Sq, H, hd = q.shape
    _, Skv, KV, hdv = v.shape
    out = torch.empty((B, Sq, H, hdv), dtype=q.dtype, device=q.device)
    strides = _attn.strides_arg(q, k, v, out)
    rc = _build.load("flash_attention").flash_attention_launch(
        _attn.DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), q_offset.data_ptr(), kvl.data_ptr(), B, Sq, Skv, H,
        KV, hd, hdv, strides, int(bool(causal)),
        0.0 if scale is None else float(scale),
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "flash_attention")
    return out


class FlashAttention(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU). Backward: the
    gradient of :func:`.ref.flash_attention_ref` at the saved q, k, v,
    as the reference's ``_fa_bwd``; none for the offsets, lengths and
    scale."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kvl, causal, scale):
        ctx.causal, ctx.scale = causal, scale
        ctx.save_for_backward(q, k, v, q_offset, kvl)
        return _forward(q, k, v, q_offset, kvl, causal, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_offset, kv_valid_len = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            out = flash_attention_ref(*ins, q_offset=q_offset,
                                      kv_valid_len=kv_valid_len,
                                      causal=ctx.causal, scale=ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, ins, g)
        return dq, dk, dv, None, None, None, None


def _norm_inputs(q, q_positions, kv_valid_len):
    """(q_offset, kv_valid_len) as contiguous (B,) int32, as the
    reference's ``_norm_inputs``: offset 0 and length 2^30 (no key
    masked) by default."""
    B = q.shape[0]
    if q_positions is None:
        q_offset = torch.zeros((B,), dtype=torch.int32, device=q.device)
    else:
        q_offset = q_positions[:, 0].to(torch.int32).contiguous()
    if kv_valid_len is None:
        kvl = torch.full((B,), 1 << 30, dtype=torch.int32, device=q.device)
    else:
        kvl = kv_valid_len.to(torch.int32).contiguous()
    return q_offset, kvl


def flash_attention(q, k, v, *, q_positions=None, kv_valid_len=None,
                    causal=True, scale=None):
    """q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd[v]) -> (B,Sq,H,hdv) in q's
    dtype. ``q_positions`` (B,Sq): absolute positions, of which the
    first gives each sequence's query offset (default 0);
    ``kv_valid_len`` (B,): keys at or past it are masked (default none);
    ``scale``: the scores' scale (default hd^-1/2; MLA with YaRN gives
    its own). Differentiable in q, k and v (:class:`FlashAttention`)."""
    q_offset, kvl = _norm_inputs(q, q_positions, kv_valid_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, q_offset, kvl, causal, scale)
    return _forward(q, k, v, q_offset, kvl, causal, scale)
