"""Wrappers of the merged halo pack/unpack kernels and of Faces' increment
(csrc/halo_pack.cu).

Each wrapper takes its route from the device of the tensor it is given:
on a CUDA tensor it launches the hand-written kernel (or raises), on a
CPU tensor it runs the plain version from :mod:`.ref`. There is no
fallback between the two. All four forms are batched over the leading
rank dim R and use the same two kernels. The pack is a pure copy and
takes any dtype of 1, 2, 4 or 8 bytes; the unpack adds in the surfaces'
dtype (float32, float64, bfloat16, float16, int32, int64, uint8, int8 or
int16), each add rounded to it in ``DIRECTIONS`` order (integers wrap),
as the plain version:

  * :func:`halo_pack_split` — (R, nx, ny, nz) -> 26 contiguous (R, s_d)
    send buffers, one launch (Faces' merged ``pack_all``);
  * :func:`halo_pack` — the same kernel into one flat (R, total) buffer;
  * :func:`halo_unpack_split` — 26 (R, s_d) surfaces -> (R, nx, ny, nz)
    accumulator, one launch; with ``with_max=True`` the same launch also
    writes the per-rank max|acc| (Faces' merged ``unpack_compare``);
  * :func:`halo_unpack` — the same kernel from one flat (R, total) buffer;
  * :func:`faces_increment` — ``(src + 1) + mod(it, 3)`` and ``it + 1``,
    one launch that reads and writes each cell once (Faces' increment).

The kernels address each of the 26 surfaces through its own base
pointer and rank stride, so the split and flat forms differ only in the
pointers the wrapper passes, and a surface may be a view whose ranks sit
at any stride (the parts ``ref.unpack_flat`` splits off a packed put) as
long as each rank's elements are contiguous.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.halo import (DIRECTIONS, _max_abs, offsets_of,
                                  surface_size)
from repro_torch.kernels import _build
from repro_torch.kernels.counter_bump.ops import rank_rows
from repro_torch.kernels.halo_pack import ref

NDIR = len(DIRECTIONS)


@functools.lru_cache(maxsize=None)
def _geometry(n):
    """(surface sizes, surface offsets, total) of a block shape ``n``, in
    ``DIRECTIONS`` order — host work done once per shape, not per call."""
    offs, total = offsets_of(n)
    return (tuple(surface_size(n, d) for d in DIRECTIONS),
            tuple(offs[d][0] for d in DIRECTIONS), total)


def _check_cuda(t: torch.Tensor, what: str, device=None):
    """Device of a tensor the kernel reads or writes."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{what}: on {t.device}, but the current CUDA "
                         f"device is {torch.cuda.current_device()}; the "
                         "kernel launches on the current device")


# the unpack kernel's accumulator types, by the C entry's dtype code
UNPACK_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
                 torch.float16: 3, torch.int32: 4, torch.int64: 5,
                 torch.uint8: 6, torch.int8: 7, torch.int16: 8}


def _check_unpack_dtype(t: torch.Tensor, what: str, dtype: torch.dtype):
    """The unpack adds in one of UNPACK_DTYPES, every surface in the
    first one's."""
    if t.dtype not in UNPACK_DTYPES:
        raise TypeError(f"{what}: the kernel adds float32, float64, "
                        f"bfloat16, float16, int32, int64, uint8, int8 or "
                        f"int16, got {t.dtype}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: is {t.dtype}, the first surface "
                        f"{dtype}; the surfaces must share one dtype")


def _check_with_max(dtype: torch.dtype):
    """The per-rank max|acc| exists where the plain ``_max_abs`` (an
    infinity norm) takes the dtype: floating types only."""
    if not dtype.is_floating_point:
        raise TypeError(f"halo unpack: with_max takes a floating "
                        f"accumulator (the norm refuses {dtype})")


def _rows(t: torch.Tensor, s: int, what: str) -> torch.Tensor:
    """``t`` (R, ...) viewed as (R, s) rows, one per rank, without a copy:
    each rank's ``s`` elements must be contiguous, its rank stride is
    free."""
    rows = rank_rows(t)
    if rows is None:
        raise ValueError(f"{what}: each rank's {s} elements must be "
                         f"contiguous (shape {tuple(t.shape)}, strides "
                         f"{t.stride()})")
    return rows


def _check_field(field: torch.Tensor):
    if field.dim() != 4 or min(field.shape[1:]) < 1:
        raise ValueError("halo pack: field must be (R, nx, ny, nz), got "
                         f"{tuple(field.shape)}")


def _pointer_table(tensors, strides, base_offsets=None):
    ptrs = (ctypes.c_uint64 * NDIR)()
    strd = (ctypes.c_int64 * NDIR)()
    for k, (t, s) in enumerate(zip(tensors, strides)):
        off = 0 if base_offsets is None else base_offsets[k]
        ptrs[k] = t.data_ptr() + off * t.element_size()
        strd[k] = s
    return ptrs, strd


def _launch_pack(field, dst_tensors, dst_strides, dst_offsets=None):
    _check_cuda(field, "halo pack: field")
    es = field.element_size()
    # a pure copy: the kernel moves elements as bytes, whatever their type
    if es not in (1, 2, 4, 8):
        raise TypeError("halo pack: the kernel takes elements of 1, 2, 4 or "
                        f"8 bytes, got {field.dtype}")
    if not field.is_contiguous() or field.data_ptr() % es:
        raise ValueError("halo pack: field must be contiguous and aligned "
                         "to its element size")
    R, nx, ny, nz = field.shape
    ptrs, strd = _pointer_table(dst_tensors, dst_strides, dst_offsets)
    rc = _build.load("halo_pack").halo_pack_launch(
        field.data_ptr(), R, nx, ny, nz, es, ptrs, strd,
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "halo_pack")


def _unpack(R, n, device, with_max, src_tensors, src_strides,
            src_offsets=None):
    """New accumulator (and, ``with_max``, the per-rank max|acc|) from one
    launch of the unpack kernel."""
    dtype = src_tensors[0].dtype
    acc = torch.empty((R,) + n, dtype=dtype, device=device)
    # the kernel lands each block's max on its rank's slot: zero first
    rmax = torch.zeros((R, 1), dtype=dtype, device=device) \
        if with_max else None
    if R:
        ptrs, strd = _pointer_table(src_tensors, src_strides, src_offsets)
        rc = _build.load("halo_pack").halo_unpack_launch(
            acc.data_ptr(), UNPACK_DTYPES[dtype], R, *n, ptrs, strd,
            None if rmax is None else rmax.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "halo_unpack")
    return (acc, rmax) if with_max else acc


def _plain_unpack(acc, with_max):
    return (acc, _max_abs(acc)) if with_max else acc


def halo_pack_split(field):
    """(R, nx, ny, nz) -> tuple of the 26 surfaces, each a new contiguous
    (R, s_d) tensor of the field's dtype, in ``DIRECTIONS`` order (on the
    card: any dtype of 1, 2, 4 or 8 bytes)."""
    _check_field(field)
    if field.device.type == "cpu":
        return ref.halo_pack_split_ref(field)
    sizes, _, _ = _geometry(tuple(field.shape[1:]))
    R = field.shape[0]
    outs = tuple(torch.empty((R, s), dtype=field.dtype, device=field.device)
                 for s in sizes)
    if R:
        _launch_pack(field, outs, sizes)
    return outs


def halo_pack(field):
    """(R, nx, ny, nz) -> flat (R, total) merged surface buffer of the
    field's dtype at ``offsets_of`` offsets (on the card: any dtype of 1,
    2, 4 or 8 bytes)."""
    _check_field(field)
    if field.device.type == "cpu":
        return ref.halo_pack_ref(field)
    _, offs, total = _geometry(tuple(field.shape[1:]))
    R = field.shape[0]
    out = torch.empty((R, total), dtype=field.dtype, device=field.device)
    if R:
        _launch_pack(field, [out] * NDIR, [total] * NDIR, offs)
    return out


def halo_unpack_split(recvs, n, with_max=False):
    """26 surfaces (each (R, s_d), ``DIRECTIONS`` order) -> new
    (R, nx, ny, nz) accumulator of their dtype: every cell is zero plus,
    in ``DIRECTIONS`` order, each surface that contains it, rounded to
    the dtype after each add. ``with_max`` returns ``(acc, max)``, max
    the per-rank max|acc| as (R, 1), from the same launch (floating
    dtypes only)."""
    n = tuple(int(x) for x in n)
    if len(recvs) != NDIR:
        raise ValueError(f"halo unpack: expected {NDIR} surfaces, got "
                         f"{len(recvs)}")
    R = recvs[0].shape[0]
    sizes, _, _ = _geometry(n)
    for d, s, r in zip(DIRECTIONS, sizes, recvs):
        if r.numel() != R * s or r.shape[0] != R:
            raise ValueError(f"halo unpack: surface {d} has shape "
                             f"{tuple(r.shape)}, expected ({R}, {s})")
    if with_max:
        _check_with_max(recvs[0].dtype)
    if recvs[0].device.type == "cpu":
        return _plain_unpack(ref.halo_unpack_split_ref(recvs, n), with_max)
    rows = []
    for d, s, r in zip(DIRECTIONS, sizes, recvs):
        _check_cuda(r, f"halo unpack: surface {d}", recvs[0].device)
        _check_unpack_dtype(r, f"halo unpack: surface {d}", recvs[0].dtype)
        rows.append(_rows(r, s, f"halo unpack: surface {d}"))
    return _unpack(R, n, recvs[0].device, with_max, rows,
                   [r.stride(0) for r in rows])


def halo_unpack(flat, n, with_max=False):
    """flat (R, total) -> new (R, nx, ny, nz) accumulator of its dtype
    (and, ``with_max``, the per-rank max|acc|, as
    :func:`halo_unpack_split`)."""
    n = tuple(int(x) for x in n)
    _, offs, total = _geometry(n)
    if flat.dim() != 2 or flat.shape[1] != total:
        raise ValueError(f"halo unpack: flat must be (R, {total}), got "
                         f"{tuple(flat.shape)}")
    if with_max:
        _check_with_max(flat.dtype)
    if flat.device.type == "cpu":
        return _plain_unpack(ref.halo_unpack_ref(flat, n), with_max)
    _check_cuda(flat, "halo unpack: flat")
    _check_unpack_dtype(flat, "halo unpack: flat", flat.dtype)
    R = flat.shape[0]
    flat = _rows(flat, total, "halo unpack: flat")
    return _unpack(R, n, flat.device, with_max, [flat] * NDIR,
                   [flat.stride(0)] * NDIR, offs)


# the increment's element types, by the C entry's dtype code
INCREMENT_DTYPES = {torch.float32: 0, torch.float64: 1}


def faces_increment(src, it):
    """Faces' increment: new tensors ``(src + 1.0) + mod(it, 3.0)``, each
    rank's step broadcast over its block and each add rounded, and
    ``it + 1.0``; ``src`` (R, nx, ny, nz), ``it`` (R, 1) on its device,
    neither written into. On the card one launch: float32 or float64,
    ``src`` and ``it`` of one dtype, both contiguous, ``src`` 16-byte
    aligned."""
    if src.dim() != 4 or min(src.shape[1:]) < 1:
        raise ValueError("faces increment: src must be (R, nx, ny, nz), "
                         f"got {tuple(src.shape)}")
    R = src.shape[0]
    if tuple(it.shape) != (R, 1):
        raise ValueError(f"faces increment: it must be ({R}, 1), got "
                         f"{tuple(it.shape)}")
    if it.device != src.device:
        raise ValueError(f"faces increment: it on {it.device}, src on "
                         f"{src.device}")
    if src.device.type == "cpu":
        return ref.faces_increment_ref(src, it)
    _check_cuda(src, "faces increment: src")
    if src.dtype not in INCREMENT_DTYPES or it.dtype != src.dtype:
        raise TypeError("faces increment: the kernel takes float32 or "
                        f"float64, src and it alike; got {src.dtype} and "
                        f"{it.dtype}")
    if not (src.is_contiguous() and it.is_contiguous()) \
            or src.data_ptr() % 16:
        raise ValueError("faces increment: src and it must be contiguous, "
                         "src 16-byte aligned")
    out = torch.empty(src.shape, dtype=src.dtype, device=src.device)
    it_out = torch.empty((R, 1), dtype=it.dtype, device=it.device)
    if R:
        rc = _build.load("halo_pack").faces_increment_launch(
            src.data_ptr(), it.data_ptr(), out.data_ptr(), it_out.data_ptr(),
            INCREMENT_DTYPES[src.dtype], R, src[0].numel(),
            torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "faces_increment")
    return out, it_out
