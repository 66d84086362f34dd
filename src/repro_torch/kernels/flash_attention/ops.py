"""Wrapper of the flash attention kernel (csrc/flash_attention.cu).

On a CUDA tensor it launches the hand-written kernel, or raises if the
kernel does not take the inputs (:func:`.._attn.check_inputs`); on a CPU
tensor it runs the plain version :func:`.ref.flash_attention_ref`. No
fallback between the two. Forward only: serving needs no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _attn, _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q, k, v, *, q_positions=None, kv_valid_len=None,
                    causal=True):
    """q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd[v]) -> (B,Sq,H,hdv) in q's
    dtype. ``q_positions`` (B,Sq): absolute positions, of which the
    first gives each sequence's query offset (default 0);
    ``kv_valid_len`` (B,): keys at or past it are masked (default none)."""
    B = q.shape[0]
    if q_positions is None:
        q_offset = torch.zeros((B,), dtype=torch.int32, device=q.device)
    else:
        q_offset = q_positions[:, 0].to(torch.int32)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_offset=q_offset,
                                   kv_valid_len=kv_valid_len, causal=causal)
    if kv_valid_len is None:
        kvl = torch.full((B,), 1 << 30, dtype=torch.int32, device=q.device)
    else:
        kvl = kv_valid_len.to(torch.int32).contiguous()
    q_offset = q_offset.contiguous()
    _attn.check_inputs("flash attention", q, k, v, q_offset, kvl)
    _, Sq, H, hd = q.shape
    _, Skv, KV, hdv = v.shape
    out = torch.empty((B, Sq, H, hdv), dtype=q.dtype, device=q.device)
    strides = _attn.strides_arg(q, k, v, out)
    rc = _build.load("flash_attention").flash_attention_launch(
        _attn.DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), q_offset.data_ptr(), kvl.data_ptr(), B, Sq, Skv, H,
        KV, hd, hdv, strides, int(bool(causal)),
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "flash_attention")
    return out
