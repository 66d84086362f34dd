"""Plain PyTorch version of the flash attention kernel: a copy of the
JAX package's ``kernels/flash_attention/ref.py`` (full score matrix,
GQA by repeating KV heads, softmax weights cast to ``v``'s dtype), with
an optional softmax scale the copy's original has not."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, q_offset=None, kv_valid_len=None,
                        causal=True, scale=None):
    """q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd[v]); GQA via head repeat.
    q_offset: (B,) absolute position of q[:,0]; kv_valid_len: (B,);
    scale: the scores' scale, default hd^-1/2."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    scores = torch.einsum("bqhd,bshd->bhqs", q, k).float() * scale
    skv = k.shape[1]
    kv_idx = torch.arange(skv, device=q.device)
    if q_offset is None:
        q_offset = torch.zeros((B,), dtype=torch.int32, device=q.device)
    q_pos = q_offset[:, None] + torch.arange(Sq, device=q.device)[None, :]
    mask = torch.ones((B, Sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_idx[None, None, :] <= q_pos[:, :, None]
    if kv_valid_len is not None:
        mask &= kv_idx[None, None, :] < kv_valid_len[:, None, None]
    scores = torch.where(mask[:, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, v)
