"""Plain PyTorch version of the WKV6 kernel: the JAX package's
``kernels/rwkv6/ref.py`` term for term, as a loop over time in float32
(any S >= 1)."""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, logw, u, s0):
    """r,k,v,logw: (B,S,H,hd); u: (H,hd); s0: (B,H,hd,hd).
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    with w_t = exp(logw_t). Returns (y (B,S,H,hd) f32, sT (B,H,hd,hd) f32);
    s0 is not written."""
    r, k, v, logw = (a.float() for a in (r, k, v, logw))
    w = torch.exp(logw)
    u = u.float()[None, :, :, None]
    s = s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhc,bhcv->bhv", r[:, t], s + u * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s
