"""Wrappers of the norm and RoPE kernels (csrc/norm_rope.cu).

On CUDA tensors each launches its hand-written kernel, or raises if the
kernel does not take the inputs; on CPU tensors it runs the plain
version from :mod:`.ref`. No fallback between the two, and no gradient:
the model layers (``models/layers.py`` ``kernel_route``) call these only
where none is needed, and run the plain composition elsewhere.

  * :func:`rmsnorm` — ``s = x + delta`` and ``y = RMSNorm(s)``, one launch
    that reads x and delta and writes s and y once (a block's residual add
    and the norm after it);
  * :func:`rope_cache` — q and k rotated and k and v written into the KV
    cache rows of the step, one launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.norm_rope.ref import rmsnorm_ref, rope_cache_ref

# the dtypes both kernels take, and their codes in the C entries
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _on_card(what: str, *tensors) -> None:
    dev = torch.cuda.current_device()
    for t in tensors:
        if t.device.type != "cuda" or t.device.index != dev:
            raise ValueError(f"{what}: a tensor on {t.device}, expected the "
                             f"current CUDA device cuda:{dev}")


def _rows(what: str, t, D: int):
    """``t`` as (rows, D) with its last dim contiguous (a view where one
    exists)."""
    t2 = t.reshape(-1, D)
    if t2.stride(1) != 1 and t2.shape[0] * D > 0:
        raise ValueError(f"{what}: the last dim must be contiguous (strides "
                         f"{t.stride()})")
    return t2


def rmsnorm(x, scale, eps: float, delta=None):
    """(s, y): s = x + delta rounded to x's dtype (x itself where delta is
    None), y = s normalized over its last dim in float32, times the float32
    scale, cast back; :func:`.ref.rmsnorm_ref`'s function, s bit for bit
    and y within one unit in the last place of a bf16 or fp16 y, a few of
    a float32 one (only the sum of squares is taken in another order). x and delta: (..., D) of one dtype of
    ``DTYPES``, each last dim contiguous (rows at any stride, as a column
    slice of a wider tensor); scale: (D,) contiguous, float32 or x's dtype.
    s and y are new contiguous tensors."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps, delta)
    D = x.shape[-1]
    if x.dtype not in DTYPES or scale.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"rmsnorm: x of {sorted(map(str, DTYPES))} and a "
                        f"float32 or x-dtype scale, got {x.dtype} and "
                        f"{scale.dtype}")
    if tuple(scale.shape) != (D,) or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale must be a contiguous ({D},), got "
                         f"{tuple(scale.shape)}")
    tensors = (x, scale) if delta is None else (x, delta, scale)
    _on_card("rmsnorm", *tensors)
    x2 = _rows("rmsnorm: x", x, D)
    d2, s = None, None
    if delta is not None:
        if delta.shape != x.shape or delta.dtype != x.dtype:
            raise ValueError(f"rmsnorm: delta {tuple(delta.shape)} "
                             f"{delta.dtype} does not match x "
                             f"{tuple(x.shape)} {x.dtype}")
        d2 = _rows("rmsnorm: delta", delta, D)
        s = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x2.shape[0] and D:
        rc = _build.load("norm_rope").rmsnorm_launch(
            DTYPES[x.dtype], DTYPES[scale.dtype], x2.data_ptr(),
            x2.stride(0), None if d2 is None else d2.data_ptr(),
            0 if d2 is None else d2.stride(0),
            None if s is None else s.data_ptr(), y.data_ptr(),
            scale.data_ptr(), x2.shape[0], D, eps,
            torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "rmsnorm")
    return (x if s is None else s), y


def rope_cache(q, k, v, table, cache_k, cache_v, index):
    """q and k rotated by ``table``, k and v written into the caches:
    :func:`.ref.rope_cache_ref`'s function bit for bit, in one launch.

    q: (B, S, H, hd); k, v: (B, S, KV, hd), one dtype of ``DTYPES``, each
    last dim contiguous; table: the (cos, sin) of ``layers.rope_table``,
    float32 (B, S, 1, hd/2) (or broadcast to it), or None (no rotation:
    only the cache rows are written, and q is returned as it is);
    cache_k, cache_v: (>= B, max_len, KV, hd) of a dtype of ``DTYPES``,
    each last dim contiguous (a view of a wider cache too), written IN
    PLACE; index: ``attention.cache_index``'s (rows, cols), rows
    ``arange(B)[:, None]`` and cols (B, S) int64, so that token (b, s)
    lands in row cols[b, s] of sequence b (a row outside the cache is
    not written). Returns the rotated q, a new contiguous tensor."""
    if q.device.type == "cpu":
        return rope_cache_ref(q, k, v, table, cache_k, cache_v, index)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    rows, cols = index
    if k.shape != (B, S, KV, hd) or v.shape != k.shape or hd % 2:
        raise ValueError(f"rope_cache: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want "
                         "(B, S, H, hd) and (B, S, KV, hd), hd even")
    for what, c in (("cache_k", cache_k), ("cache_v", cache_v)):
        if c.dim() != 4 or c.shape[0] < B or tuple(c.shape[2:]) != (KV, hd):
            raise ValueError(f"rope_cache: {what} {tuple(c.shape)}, want "
                             f"(>= {B}, max_len, {KV}, {hd})")
    if cache_v.shape[1] != cache_k.shape[1]:
        raise ValueError("rope_cache: the caches' lengths differ")
    if tuple(rows.shape) != (B, 1) or tuple(cols.shape) != (B, S) \
            or cols.dtype != torch.int64:
        raise ValueError(f"rope_cache: index must be cache_index's rows "
                         f"({B}, 1) and int64 cols ({B}, {S})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype \
            or cache_k.dtype not in DTYPES or cache_v.dtype != cache_k.dtype:
        raise TypeError(f"rope_cache: q, k, v of one dtype and the caches "
                        f"of one, each of {sorted(map(str, DTYPES))}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}, {cache_k.dtype}, "
                        f"{cache_v.dtype}")
    tensors = [q, k, v, cache_k, cache_v, cols]
    if table is not None:
        cos, sin = (t.expand(B, S, 1, hd // 2) for t in table)
        if cos.dtype != torch.float32 or sin.dtype != torch.float32 \
                or cos.stride() != sin.stride():
            raise ValueError("rope_cache: cos and sin must be float32 "
                             "tensors of one layout")
        tensors += [cos, sin]
    for t in tensors:
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"rope_cache: a tensor of shape "
                             f"{tuple(t.shape)} has strides {t.stride()}; "
                             "its last dim must be contiguous")
    _on_card("rope_cache", *tensors)
    if table is None:
        qo, cos, sin, angles = q, None, None, (0, 0)
    else:
        qo = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
        angles = cos.stride()[:2]
    vals = [st for t in (q, k, v, cache_k, cache_v) for st in t.stride()[:3]]
    vals += [*angles, *cols.stride()]
    strides = (ctypes.c_int64 * len(vals))(*vals)
    rc = _build.load("norm_rope").rope_cache_launch(
        DTYPES[q.dtype], DTYPES[cache_k.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), None if table is None else qo.data_ptr(),
        cache_k.data_ptr(), cache_v.data_ptr(),
        None if cos is None else cos.data_ptr(),
        None if sin is None else sin.data_ptr(), cols.data_ptr(), strides,
        B, S, H, KV, hd, cache_k.shape[1],
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "rope_cache")
    return qo
