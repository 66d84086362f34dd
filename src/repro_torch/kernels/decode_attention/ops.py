"""Wrapper of the flash-decode kernel (csrc/decode_attention.cu).

On a CUDA tensor it launches the hand-written kernel, or raises if the
kernel does not take the inputs (:func:`.._attn.check_inputs`); on a CPU
tensor it runs the plain version :func:`.ref.decode_attention_ref`. No
fallback between the two. One launch is one call of the C entry, which
runs the split pass and the merge pass over a float32 workspace
allocated here; the split count comes from
:func:`.._attn.decode_splits`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _attn, _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q, k, v, *, q_positions=None, kv_valid_len=None):
    """q: (B,1,H,hd); k,v: (B,S,KV,hd[v]) -> (B,1,H,hdv) in q's dtype.
    Sequence b attends to keys j < min(q_positions[b, -1] + 1,
    kv_valid_len[b]) (defaults: position S - 1, valid length S)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, q_positions=q_positions,
                                    kv_valid_len=kv_valid_len)
    B, _, H, hd = q.shape
    _, S, KV, hdv = v.shape
    if q.shape[1] != 1:
        raise ValueError(f"decode attention: one query token per sequence,"
                         f" got q {tuple(q.shape)}")
    if q_positions is None:
        pos = torch.full((B,), S - 1, dtype=torch.int32, device=q.device)
    else:
        pos = q_positions[:, -1].to(torch.int32).contiguous()
    if kv_valid_len is None:
        kvl = torch.full((B,), S, dtype=torch.int32, device=q.device)
    else:
        kvl = kv_valid_len.to(torch.int32).contiguous()
    _attn.check_inputs("decode attention", q, k, v, pos, kvl,
                       head_dims=_attn.DECODE_HEAD_DIMS)
    out = torch.empty((B, 1, H, hdv), dtype=q.dtype, device=q.device)
    nsplit = _attn.decode_splits(
        S, B, KV, torch.cuda.get_device_properties(q.device)
        .multi_processor_count)
    # each split's float32 (m, l, acc[hdv]) per query head
    ws = torch.empty((B, KV, nsplit, H // KV, hdv + 2), dtype=torch.float32,
                     device=q.device)
    strides = _attn.strides_arg(q, k, v, out)
    rc = _build.load("decode_attention").decode_attention_launch(
        _attn.DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), ws.data_ptr(), pos.data_ptr(), kvl.data_ptr(), B, S,
        H, KV, hd, hdv, nsplit, strides,
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "decode_attention")
    return out
