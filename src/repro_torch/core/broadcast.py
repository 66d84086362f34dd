"""Row-broadcast (SUMMA-style) one-to-many tile fanout.

SUMMA's inner loop broadcasts the pivot A-tile along each process row
before the local tile update. This pattern lowers that fanout onto the
triggered-op DAG: per iteration one access epoch in which every rank's
freshly produced A-tile reaches ALL cols-1 peers of its row — either as

  * ``multicast=True`` (default): ONE multicast put descriptor — one
    src payload, one injection, one completion tree counted as one
    signal at the source (``STStream.put_multicast``), emitted as ONE
    ``put_multicast`` launch that reads the payload once — or
  * ``multicast=False``: cols-1 unicast puts, the fanout baseline.

Both variants deliver bit-identical bytes into the same ``recva{k}``
landing buffers, so the executors verify the multicast descriptor
against the fanout directly; the cost simulator prices the multicast at
ONE message (alpha + payload beta) versus cols-1 serialized NIC
injections.

The compute epoch is a rank-1-update flavor of SUMMA: ``spin`` derives
the iteration's pivot tile from a persistent seeded base and the step
counter (iteration-stable closures, like ring's step buffer), and
``update`` accumulates ``ctile += a @ b + sum_k recva_k @ b`` in float32
(PyTorch matmuls, left in full float32: the port enables no TF32).

Kernel closures see the GLOBAL view: every tensor carries all R ranks on
its leading dim (the JAX package's closures see one rank under
shard_map); the products are batched over it.
"""
from __future__ import annotations

import torch

from repro_torch.core.patterns import register_pattern, row_broadcast_topology
from repro_torch.core.window import torch_dtype


def make_broadcast_kernels(dtype="float32"):
    """Iteration-stable kernel closures (one set per program; re-enqueued
    every epoch). Buffers carry the leading rank dim R."""
    tdt = torch_dtype(dtype)

    def spin(abase, it):
        # fresh pivot tile each iteration, derived from the persistent
        # base and the step counter — parity-independent, so ping/pong
        # epochs produce the same values double-buffered or not
        step = it[:, 0].to(tdt)[:, None, None]
        return abase * (1.0 + 0.25 * step), it + 1

    def update(ctile, a, b, *recvs):
        # SUMMA tile update: own pivot plus every row peer's, in the
        # fixed recva1..recva{c-1} order (mcast and unicast fanout
        # deliver into the same buffers, so the sum order — and the
        # floats — match bit for bit)
        bf = b.float()
        acc = ctile + torch.bmm(a.float(), bf)
        for rv in recvs:
            acc = acc + torch.bmm(rv.float(), bf)
        return acc

    return {"spin": spin, "update": update}


def create_broadcast_window(stream, *, tile, dtype="float32",
                            name="bcast", double_buffer=False,
                            ranks_per_node=None):
    """Window with the persistent seeded base tile, the per-iteration
    pivot ``a`` (the multicast payload), the B operand, the f32
    accumulator, a step counter, and one ``recva{k}`` landing buffer per
    row peer. ``a`` and the landing buffers ping/pong under
    ``double_buffer`` (the pivot is rewritten every epoch). Dtypes are
    numpy names (see window.py)."""
    rows, cols = stream.grid_shape
    blk = (tile, tile)
    bufs = {"abase": (blk, dtype), "a": (blk, dtype), "b": (blk, dtype),
            "ctile": (blk, "float32"), "it": ((1,), "int32")}
    recvs = [f"recva{k}" for k in range(1, cols)]
    for r in recvs:
        bufs[r] = (blk, dtype)
    topo = row_broadcast_topology(rows, cols, stream.grid_axes,
                                  ranks_per_node=ranks_per_node)
    return stream.create_window(name, bufs, list(topo.group), topology=topo,
                                double_buffer=double_buffer,
                                db_names=tuple(["a"] + recvs))


@register_pattern("broadcast", grid_axes=("row", "col"),
                  default_grid=(2, 4),
                  doc="SUMMA-style row fanout: one rank's tile to every "
                      "row peer — one multicast descriptor vs cols-1 "
                      "unicast puts")
def build_broadcast_program(stream, niter, *, tile=8, dtype="float32",
                            multicast=True, merged=True,
                            host_sync_every=0, kernels=None, name="bcast",
                            double_buffer=False, ranks_per_node=None,
                            **_kw):
    """Enqueue ``niter`` SUMMA-style row-broadcast iterations: per epoch
    post -> spin kernel (produce the pivot tile) -> start -> the row
    fanout (ONE multicast put, or cols-1 unicast puts when
    ``multicast=False``) -> complete -> wait -> update kernel. Returns
    (window, kernels)."""
    stream.pattern = stream.pattern or "broadcast"
    _, cols = stream.grid_shape
    win = create_broadcast_window(stream, tile=tile, dtype=dtype, name=name,
                                  double_buffer=double_buffer,
                                  ranks_per_node=ranks_per_node)
    kernels = kernels or make_broadcast_kernels(dtype=dtype)
    q = win.qual
    recvs = [f"recva{k}" for k in range(1, cols)]
    for it in range(niter):
        phase = it % 2 if double_buffer else 0
        stream.post(win, phase=phase)
        stream.launch(kernels["spin"], [q("abase"), q("it")],
                      [q("a", phase), q("it")], label="spin")
        stream.start(win, phase=phase)
        if multicast and cols > 1:
            stream.put_multicast(win, q("a", phase),
                                 [q(r, phase) for r in recvs],
                                 [(0, k) for k in range(1, cols)],
                                 phase=phase)
        else:
            for k in range(1, cols):
                stream.put(win, q("a", phase), q(f"recva{k}", phase),
                           (0, k), phase=phase)
        stream.complete(win, phase=phase)
        stream.wait(win, phase=phase)
        stream.launch(kernels["update"],
                      [q("ctile"), q("a", phase), q("b")]
                      + [q(r, phase) for r in recvs],
                      [q("ctile")], label="update")
        if host_sync_every and (it + 1) % host_sync_every == 0 \
                and it + 1 < niter:
            stream.host_sync()
    return win, kernels
