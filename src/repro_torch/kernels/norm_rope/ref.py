"""Plain PyTorch versions of the two kernels of ``csrc/norm_rope.cu``: the
composition each replaces, and the model's own wherever the kernels do
not run (``models/layers.py`` ``add_norm`` and ``apply_rope`` are
:func:`rmsnorm_ref` and :func:`rope_ref`; :func:`rope_cache_ref` writes
the cache rows as ``models/attention.py`` ``_update_cache`` does)."""
from __future__ import annotations

import torch


def rmsnorm_ref(x, scale, eps: float, delta=None):
    """(s, y): s = x + delta in x's dtype (x itself without delta), y = s
    normalized in float32, scaled by the float32 scale and cast back."""
    s = x if delta is None else x + delta
    sf = s.float()
    var = (sf * sf).mean(dim=-1, keepdim=True)
    y = sf * torch.rsqrt(var + eps)
    return s, (y * scale.float()).to(s.dtype)


def rope_ref(x, table):
    """x (B, S, H, hd) rotated by ``table`` = (cos, sin): the two halves of
    the head dim rotated together in float32, cast back."""
    cos, sin = table
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_cache_ref(q, k, v, table, cache_k, cache_v, index):
    """q and k rotated by ``table`` (not where it is None), k and v written
    into ``cache_k`` and ``cache_v`` at the rows ``index`` (a (rows, cols)
    pair) in place, in the caches' dtype. Returns the rotated q (q itself
    without a table)."""
    if table is not None:
        q, k = rope_ref(q, table), rope_ref(k, table)
    cache_k[index] = k.to(cache_k.dtype)
    cache_v[index] = v.to(cache_v.dtype)
    return q
