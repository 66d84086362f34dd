"""Input checks and launch arguments shared by the two attention kernel
wrappers (flash attention, flash-decode). A CUDA tensor the kernels do
not take raises here, before any launch; nothing falls back."""
from __future__ import annotations

import ctypes

import torch

# (hd, hdv) pairs the flash attention kernel is compiled for; (192, 128)
# is DeepSeek-V2's MLA prefill (q, k: 128 nope + 64 rope per head, v 128)
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (192, 128))
# the pairs of the flash-decode kernel (MLA decodes by absorbed products)
DECODE_HEAD_DIMS = ((32, 32), (64, 64), (128, 128))
# the dtype code every C entry takes (the WKV6 wrapper's too)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# flash-decode's split over the key range: at most one split per
# SPLIT_MIN_KEYS keys of the cache, and enough splits for about
# SPLIT_BLOCKS_PER_SM blocks per SM. At 8 slots x 8 KV heads on an H100
# (132 SMs) 2 gives 5 splits, which ran faster than 9 or 17 (each split
# pays its own prologue and its share of the merge).
SPLIT_MIN_KEYS = 64
SPLIT_BLOCKS_PER_SM = 2


def decode_splits(S: int, B: int, KV: int, sm_count: int) -> int:
    """The number of key-range splits of one flash-decode launch, from
    host-known shapes only (the cache length S, B, KV, the card's SM
    count) and never from the device's positions or lengths, so that a
    decode step needs no host synchronisation."""
    by_len = -(-S // SPLIT_MIN_KEYS)
    by_sms = -(-SPLIT_BLOCKS_PER_SM * sm_count // max(1, B * KV))
    return max(1, min(by_len, by_sms))


def check_inputs(name: str, q, k, v, *index,
                 head_dims=HEAD_DIMS) -> None:
    """Shapes, dtypes, device and layout of a launch: q (B,Sq,H,hd),
    k (B,Skv,KV,hd), v (B,Skv,KV,hdv) of one dtype (bf16 or float32) on
    the current CUDA device, KV dividing H, (hd, hdv) in ``head_dims``,
    each last dim contiguous and every row 16-byte aligned; ``index``:
    (B,) int32 contiguous tensors on the same device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be 4-D (B, S, heads, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, hd = q.shape
    _, Skv, KV, hdk = k.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or hdk != hd:
        raise ValueError(f"{name}: shapes do not match: q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"{name}: {KV} KV heads do not divide {H} heads")
    if Skv == 0:
        raise ValueError(f"{name}: empty key range")
    if (hd, v.shape[3]) not in head_dims:
        raise ValueError(f"{name}: no kernel for head dims (hd, hdv) = "
                         f"({hd}, {v.shape[3]}); compiled for {head_dims}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share one dtype of "
                        f"{sorted(map(str, DTYPES))}, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    for what, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {what} on {t.device}, expected a "
                             "CUDA tensor")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(f"{name}: {what} on {t.device}, but the "
                             "current CUDA device is "
                             f"{torch.cuda.current_device()}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}: {what}'s last dim must be "
                             f"contiguous (strides {t.stride()})")
        row = 16 // t.element_size()
        if (t.data_ptr() % 16 or any(s % row for s in t.stride()[:3])):
            raise ValueError(f"{name}: {what}'s rows must start 16-byte "
                             f"aligned (strides {t.stride()})")
    for t in index:
        if (t.dtype != torch.int32 or t.shape != (B,)
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name}: index tensors must be contiguous "
                             f"int32 ({B},) on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def strides_arg(*tensors):
    """The (b, s, h) element strides of each tensor, as one int64 array
    for the C entry (the array must outlive the call)."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_int64 * len(vals))(*vals)
