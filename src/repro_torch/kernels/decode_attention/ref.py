"""Plain PyTorch version of the flash-decode kernel: a copy of the JAX
package's ``kernels/decode_attention/ref.py`` (single-token attention
over a KV cache, GQA by repeating KV heads)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, *, q_positions=None, kv_valid_len=None):
    """q: (B,1,H,hd); k,v: (B,S,KV,hd[v]). Causal == mask j <= pos."""
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bqhd,bshd->bhqs", q, k).float() * scale
    idx = torch.arange(S, device=q.device)
    mask = torch.ones((B, S), dtype=torch.bool, device=q.device)
    if q_positions is not None:
        mask &= idx[None, :] <= q_positions[:, -1][:, None]
    if kv_valid_len is not None:
        mask &= idx[None, :] < kv_valid_len[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, v)
