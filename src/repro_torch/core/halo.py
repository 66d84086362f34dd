"""Faces: 26-neighbor 3-D halo exchange (paper §6.2).

Weak-scaling Nekbone-style nearest-neighbor pattern: each rank owns an
(nx, ny, nz) block of spectral-element surface data and exchanges faces
(6), edges (12) and corners (8) with its 26 neighbors on a periodic
(px, py, pz) process grid.

This module provides the domain logic used by the ST stream programs:
  * DIRECTIONS          — the 26 neighbor offsets
  * pack / unpack       — surface extraction/injection; the merged forms
                          call the hand-written kernels on CUDA
                          (kernels/halo_pack) and their plain PyTorch
                          versions on the CPU
  * increment / compare — the paper's compute kernels around the exchange
                          (the increment, too, a kernel of kernels/halo_pack)
  * build_faces_program — enqueues the full Faces program on an STStream

Kernel closures see the GLOBAL view: every tensor carries all R ranks on
its leading dim (the JAX package's closures see one rank under
shard_map), so every reduction is per rank, to (R, 1).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.patterns import PatternTopology, register_pattern

DIRECTIONS: List[Tuple[int, int, int]] = [
    (dx, dy, dz)
    for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
    if (dx, dy, dz) != (0, 0, 0)
]


def surface_slices(n: Tuple[int, int, int], d: Tuple[int, int, int]):
    """Index slices of the local block that go to neighbor d.
    Face: a 1-thick slab; edge: 1x1xn pencil; corner: single cell."""
    out = []
    for dim, (nd, dd) in enumerate(zip(n, d)):
        if dd == -1:
            out.append(slice(0, 1))
        elif dd == 1:
            out.append(slice(nd - 1, nd))
        else:
            out.append(slice(0, nd))
    return tuple(out)


def surface_size(n, d) -> int:
    return int(np.prod([1 if dd != 0 else nd for nd, dd in zip(n, d)]))


def offsets_of(n, directions=DIRECTIONS):
    offs, cur = {}, 0
    for d in directions:
        s = surface_size(n, d)
        offs[d] = (cur, s)
        cur += s
    return offs, cur


def _max_abs(acc):
    """Per-rank max|acc| as (R, 1): the infinity norm is one pass and
    exact (a max does no rounding)."""
    return torch.linalg.vector_norm(acc.reshape(acc.shape[0], -1),
                                    ord=float("inf"), dim=1, keepdim=True)


def make_faces_kernels(n):
    """Iteration-stable kernel closures (created once per program; the same
    function objects are enqueued every iteration, like preloaded GPU
    kernels). Every closure returns new tensors and leaves its inputs
    untouched, so a state dict handed to ``synchronize`` is never
    written into."""
    from repro_torch.kernels.halo_pack.ops import (faces_increment,
                                                   halo_pack_split,
                                                   halo_unpack_split)

    n = tuple(n)

    def increment(src, it):
        # (src + 1.0) + mod(it, 3.0), the per-rank iteration count
        # broadcast over the rank's block, and it + 1.0: one launch on the
        # card. A closure of its own per call, as every kernel here, so
        # each program's ops keep the function identities (fn_token) the
        # JAX package's do
        return faces_increment(src, it)

    def pack_all(src):
        # merged pack (§5.4): one launch writes all 26 send buffers
        return halo_pack_split(src)

    packs = {}
    unpacks = {}
    for d in DIRECTIONS:
        sl = (slice(None),) + surface_slices(n, d)
        shp = tuple(1 if dd != 0 else nd for nd, dd in zip(n, d))

        def pack_d(src, sl=sl):
            return src[sl].reshape(src.shape[0], -1)
        packs[d] = pack_d

        def unpack_d(acc, r, sl=sl, shp=shp):
            out = acc.clone()
            out[sl] += r.reshape((acc.shape[0],) + shp)
            return out
        unpacks[d] = unpack_d

    def unpack_compare(src, *recvs):
        # merged unpack+compare (§5.4): one launch gathers all 26 surfaces
        # and takes the per-rank max|acc| in the same pass
        return halo_unpack_split(recvs, n, with_max=True)

    def zero_acc(acc):
        return torch.zeros_like(acc)

    def compare(acc):
        return _max_abs(acc)

    return {"increment": increment, "pack_all": pack_all, "packs": packs,
            "unpacks": unpacks, "unpack_compare": unpack_compare,
            "zero_acc": zero_acc, "compare": compare}


# ---------------------------------------------------------------------------
# Program construction
# ---------------------------------------------------------------------------

def faces_topology(grid_axes=("x", "y", "z"),
                   ranks_per_node=None) -> PatternTopology:
    """26-neighbor halo group; opposite = component-wise negation.
    ``ranks_per_node`` maps consecutive linear ranks onto hardware nodes
    so lowering can tag each direction's put intra- vs inter-node."""
    return PatternTopology("faces", tuple(grid_axes),
                           tuple(DIRECTIONS),
                           ranks_per_node=ranks_per_node)


def create_faces_window(stream, n, name="faces", extra_buffers=None,
                        double_buffer=False, ranks_per_node=None):
    """Window with: src block, halo recv buffer per direction, accumulator,
    and an iteration counter so kernels are iteration-independent.
    ``double_buffer`` gives every send/recv surface (and the signal
    counters) a ping/pong pair so alternating epochs never touch the same
    communication buffers. Dtypes are numpy names (see window.py)."""
    bufs = {"src": (tuple(n), "float32"),
            "acc": (tuple(n), "float32"),
            "it": ((1,), "float32"),
            "res": ((1,), "float32")}
    db_names = []
    for d in DIRECTIONS:
        bufs[f"recv{d[0]}{d[1]}{d[2]}"] = ((surface_size(n, d),), "float32")
        bufs[f"send{d[0]}{d[1]}{d[2]}"] = ((surface_size(n, d),), "float32")
        db_names += [f"recv{d[0]}{d[1]}{d[2]}", f"send{d[0]}{d[1]}{d[2]}"]
    if extra_buffers:
        bufs.update(extra_buffers)
    return stream.create_window(
        name, bufs, DIRECTIONS,
        topology=faces_topology(stream.grid_axes,
                                ranks_per_node=ranks_per_node),
        double_buffer=double_buffer, db_names=db_names)


def enqueue_faces_iteration(stream, win, n, kernels, merged=True, phase=0):
    """One inner-loop Faces iteration (paper Fig. 9b structure):
    post -> increment kernel -> start -> 26 puts -> complete -> wait ->
    unpack+compare kernel. All enqueued; nothing executes until
    synchronize(). `kernels` from make_faces_kernels(n). ``phase`` picks
    the ping/pong buffer+counter set on a double-buffered window."""
    def q(b):
        return win.qual(b, phase)

    stream.post(win, phase=phase)
    stream.launch(kernels["increment"], [q("src"), q("it")],
                  [q("src"), q("it")], label="increment")
    # pack kernel(s): merged = ONE launch extracting all 26 surfaces
    if merged:
        stream.launch(kernels["pack_all"], [q("src")],
                      [q(f"send{d[0]}{d[1]}{d[2]}") for d in DIRECTIONS],
                      label="pack_merged")
    else:
        for d in DIRECTIONS:
            stream.launch(kernels["packs"][d], [q("src")],
                          [q(f"send{d[0]}{d[1]}{d[2]}")],
                          label=f"pack{d}")
    stream.start(win, phase=phase)
    for d in DIRECTIONS:
        stream.put(win, q(f"send{d[0]}{d[1]}{d[2]}"),
                   q(f"recv{d[0]}{d[1]}{d[2]}"), d, phase=phase)
    stream.complete(win, phase=phase)
    stream.wait(win, phase=phase)

    names = [f"recv{d[0]}{d[1]}{d[2]}" for d in DIRECTIONS]
    if merged:
        stream.launch(kernels["unpack_compare"],
                      [q("src")] + [q(x) for x in names],
                      [q("acc"), q("res")], label="unpack_merged")
    else:
        stream.launch(kernels["zero_acc"], [q("acc")], [q("acc")],
                      label="zero_acc")
        for d, nm in zip(DIRECTIONS, names):
            stream.launch(kernels["unpacks"][d], [q("acc"), q(nm)],
                          [q("acc")], label=f"unpack{d}")
        stream.launch(kernels["compare"], [q("acc")], [q("res")],
                      label="compare")


def build_faces_program(stream, n, niter, merged=True, kernels=None,
                        host_sync_every=0, extra_buffers=None,
                        overlap_kernel=None, name="faces",
                        double_buffer=False, ranks_per_node=None):
    """Enqueue the FULL Faces benchmark program: window + kernels + niter
    inner-loop iterations. ``host_sync_every=k`` inserts an application-
    level host_sync() every k iterations (paper §5.2.1 throttling — each
    chunk becomes its own program segment). ``overlap_kernel`` enqueues
    an independent compute launch per iteration (paper §6.7); it runs on
    a buffer from ``extra_buffers``. ``double_buffer`` alternates epochs
    over ping/pong send/recv+counter sets so a multi-stream schedule
    (``nstreams>1``) can run epoch e+1's transfers during epoch e's
    compute. ``ranks_per_node`` sets the hardware node mapping on the
    window topology: each direction's put lowers with an intra/inter
    link tag, and ``pack`` scheduling aggregates off-node directions
    whose rank permutations coincide into packed descriptors.
    Returns (window, kernels)."""
    stream.pattern = stream.pattern or "faces"
    win = create_faces_window(stream, n, name=name,
                              extra_buffers=extra_buffers,
                              double_buffer=double_buffer,
                              ranks_per_node=ranks_per_node)
    kernels = kernels or make_faces_kernels(n)
    for it in range(niter):
        enqueue_faces_iteration(stream, win, n, kernels, merged=merged,
                                phase=(it % 2 if double_buffer else 0))
        if overlap_kernel is not None:
            fn, buf = overlap_kernel
            stream.launch(fn, [win.qual(buf)], [win.qual(buf)],
                          label="overlap")
        if host_sync_every and (it + 1) % host_sync_every == 0 \
                and it + 1 < niter:
            stream.host_sync()
    return win, kernels


@register_pattern("faces", grid_axes=("x", "y", "z"),
                  default_grid=(2, 2, 2),
                  doc="26-neighbor 3-D halo exchange (paper §6.2)")
def _faces_pattern(stream, niter, *, n=(4, 4, 4), merged=True,
                   host_sync_every=0, **kw):
    return build_faces_program(stream, tuple(n), niter, merged=merged,
                               host_sync_every=host_sync_every, **kw)
