"""Plain PyTorch versions of the merged halo pack/unpack and of Faces'
increment (batched over a leading rank dim), plus the GENERIC flat
pack/unpack and chunk helpers the executors use to materialize packed
multi-buffer and chunked put descriptors (schedule.pack_puts /
schedule.chunk_puts) — a pure byte reshuffle, so packed and chunked
schedules stay bit-identical to the plain one.

The CPU path runs these; on CUDA the wrappers in
:mod:`repro_torch.kernels.halo_pack.ops` launch the hand-written kernels
instead, and these stay the yardstick they are held to. Every function
here returns new tensors or views and never writes into its inputs.
"""
from __future__ import annotations

import torch

from repro_torch.core.halo import DIRECTIONS, offsets_of, surface_slices


def _surface_shape(n, d):
    return tuple(1 if dd != 0 else nd for nd, dd in zip(n, d))


def pack_flat(parts):
    """Pack N same-dtype buffers (each (R, *local)) into one contiguous
    (R, total) staging buffer — the origin side of a packed put."""
    return torch.cat([p.reshape(p.shape[0], -1) for p in parts], dim=1)


def unpack_flat(flat, like):
    """Split a (R, total) staging buffer back into buffers shaped like
    the templates in ``like`` — the target side of a packed put. The
    parts are views of ``flat``."""
    out, o = [], 0
    for tmpl in like:
        s = tmpl.numel() // tmpl.shape[0]
        out.append(flat[:, o:o + s].reshape(tmpl.shape))
        o += s
    return out


def chunk_gather(parts, offset, count):
    """Origin side of one CHUNK of a pipelined put (schedule.chunk_puts):
    columns [offset, offset+count) of the per-rank flat concatenation of
    ``parts`` (the same logical payload ``pack_flat`` stages, for packed
    puts the whole group), gathered without materializing the full
    concat — each chunk touches only the buffers it overlaps."""
    pieces, pos = [], 0
    for p in parts:
        f = p.reshape(p.shape[0], -1)
        n = f.shape[1]
        a, b = max(offset - pos, 0), min(offset + count - pos, n)
        if a < b:
            pieces.append(f[:, a:b])
        pos += n
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)


def chunk_scatter(arrived, dsts, offset, count):
    """Target side of one chunk: write the arrived (R, count) slice into
    a copy of the overlapped region of each destination buffer's flat
    view; returns the updated buffers (non-overlapped ones unchanged,
    the inputs untouched). The union of a chain's chunks covers every
    destination element exactly once, so a chunked schedule stays
    bit-identical to the monolithic one — including the zero-fill
    non-receivers get on non-periodic grids."""
    out, pos, taken = [], 0, 0
    for d in dsts:
        r = d.shape[0]
        n = d.numel() // r
        a, b = max(offset - pos, 0), min(offset + count - pos, n)
        if a < b:
            flat = d.reshape(r, n).clone()
            flat[:, a:b] = arrived[:, taken:taken + (b - a)]
            out.append(flat.reshape(d.shape))
            taken += b - a
        else:
            out.append(d)
        pos += n
    return out


def halo_pack_split_ref(field):
    """field (R, nx, ny, nz) -> the 26 surfaces, each (R, s_d), in
    ``DIRECTIONS`` order."""
    n = tuple(field.shape[1:])
    return tuple(field[(slice(None),) + surface_slices(n, d)]
                 .reshape(field.shape[0], -1) for d in DIRECTIONS)


def halo_pack_ref(field):
    """field (R, nx, ny, nz) -> flat (R, total) merged surface buffer at
    ``offsets_of`` offsets."""
    return torch.cat(halo_pack_split_ref(field), dim=1)


def halo_unpack_split_ref(recvs, n):
    """26 received surfaces (each (R, s_d), ``DIRECTIONS`` order) ->
    (R, nx, ny, nz) accumulator: each surface is added onto the face
    toward its direction, in ``DIRECTIONS`` order (a corner cell gets 7
    adds, interior cells stay 0)."""
    n = tuple(n)
    R = recvs[0].shape[0]
    acc = torch.zeros((R,) + n, dtype=recvs[0].dtype,
                      device=recvs[0].device)
    for d, buf in zip(DIRECTIONS, recvs):
        acc[(slice(None),) + surface_slices(n, d)] += buf.reshape(
            (R,) + _surface_shape(n, d))
    return acc


def halo_unpack_ref(flat, n):
    """flat (R, total) received buffer -> (R, nx, ny, nz) accumulator."""
    offs, _ = offsets_of(tuple(n))
    return halo_unpack_split_ref(
        [flat[:, o:o + s] for o, s in (offs[d] for d in DIRECTIONS)], n)


def faces_increment_ref(src, it):
    """src (R, nx, ny, nz), it (R, 1) -> (``(src + 1.0) + mod(it, 3.0)``,
    ``it + 1.0``): the JAX package's association, each rank's iteration
    count broadcast over its block."""
    step = torch.remainder(it, 3.0).reshape((-1,) + (1,) * (src.dim() - 1))
    return (src + 1.0) + step, it + 1.0
