"""Descriptor emission (shared by every executor) and the fused executor.

:func:`emit_node` applies one scheduled descriptor's state effect with
eager PyTorch ops and the port's kernels; ``run_compiled`` and
``run_host`` (:mod:`repro_torch.core.backends`) and :func:`run_fused`
below all emit through it. The cost simulator in
:mod:`repro_torch.core.throttle` walks the same DAG without emitting.

Virtual ranks on one device: every state tensor holds all R ranks on its
leading dim, so

  * a put (``ppermute`` in the JAX package) is a copy permuted along the
    rank dim by ``stream.perm_for``; ranks with no source in that
    direction (non-periodic grids) receive zeros;
  * the JAX package's ``axis_index``-based arrival mask is an (R,) mask
    over that dim;
  * dependency ties (``optimization_barrier`` there) are the identity:
    one CUDA stream executes kernels in emission order, and
    ``stream_interleaved_order`` and the segment plan's wave order are
    topological orders of the scheduled DAG, so every edge is already
    respected;
  * every counter effect — a post signal, fused or not, and every chained
    completion signal, wire or local — is ONE counter bump
    ``sig + upd`` (the hand-written kernel on CUDA), where ``upd`` is a
    precomputed (R, npeers) update holding each branch's arrival mask in
    its slot. Counters are integers, so this equals the JAX package's
    per-slot adds exactly.

Index tensors, masks and counter updates are device tables built once
per direction when the stream allocates its state
(:func:`prepare_tables`), so emission copies nothing from the host.

Nothing here writes into a tensor that a state key may alias: every
effect rebinds the key to a new tensor (the only in-place op fills a
freshly allocated put destination), so a state dict handed to an
executor is never modified and views (``unpack_flat``, the chunk
helpers) can share storage safely.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.counter_bump.ops import counter_bump
from repro_torch.kernels.halo_pack.ref import (chunk_gather, chunk_scatter,
                                               pack_flat, unpack_flat)

# ---------------------------------------------------------------------------
# device tables (built once per stream, before any emission)
# ---------------------------------------------------------------------------


def _perm_index(stream, direction):
    """Device index tensors of a put in ``direction``: ``("gather", idx)``
    when every rank receives (idx[dst] = src), else
    ``("scatter", src_idx, dst_idx)`` for a zero-filled destination."""
    key = ("perm", tuple(direction))
    t = stream._device_tables.get(key)
    if t is None:
        pairs = stream.perm_for(tuple(direction))
        dev = stream.device
        if len(pairs) == stream.num_ranks:
            idx = np.empty((stream.num_ranks,), np.int64)
            for src, dst in pairs:
                idx[dst] = src
            t = ("gather", torch.as_tensor(idx, device=dev))
        else:
            src = np.array([p[0] for p in pairs], np.int64)
            dst = np.array([p[1] for p in pairs], np.int64)
            t = ("scatter", torch.as_tensor(src, device=dev),
                 torch.as_tensor(dst, device=dev))
        stream._device_tables[key] = t
    return t


def _arrival_mask(stream, direction) -> np.ndarray:
    """1 where a rank RECEIVES a payload sent in ``direction`` —
    non-periodic boundary ranks have no source and must not see a
    completion bump (host array; it only feeds counter updates)."""
    recv = np.zeros((stream.num_ranks,), np.int32)
    for _, dst in stream.perm_for(tuple(direction)):
        recv[dst] = 1
    return recv


def _counter_update(stream, slots, npeers: int) -> torch.Tensor:
    """(R, npeers) int32 device tensor: each (slot, direction) branch's
    arrival mask added into its slot column."""
    key = ("bump", tuple((s, tuple(d)) for s, d in slots), npeers)
    t = stream._device_tables.get(key)
    if t is None:
        upd = np.zeros((stream.num_ranks, npeers), np.int32)
        for slot, d in slots:
            upd[:, slot] += _arrival_mask(stream, d)
        t = torch.as_tensor(upd, device=stream.device)
        stream._device_tables[key] = t
    return t


def prepare_tables(stream) -> None:
    """Build every device table a window's protocol uses: the permuted-
    copy index of each group direction, the single-slot counter update
    of each direction (unfused post signals, chained completions) and
    the merged post update of the whole group."""
    for win in stream.windows.values():
        npeers = max(len(win.group), 1)
        merged = []
        for d in win.group:
            slot = win.opposite_index(d)
            _perm_index(stream, d)
            _counter_update(stream, ((slot, tuple(d)),), npeers)
            merged.append((slot, tuple(d)))
        _counter_update(stream, tuple(merged), npeers)


# ---------------------------------------------------------------------------
# emission
# ---------------------------------------------------------------------------

def _ppermute(stream, x, direction):
    idx = _perm_index(stream, direction)
    if idx[0] == "gather":
        return x.index_select(0, idx[1])
    _, src, dst = idx
    out = torch.zeros_like(x)
    # in place on the fresh destination only: no state key aliases it
    out.index_copy_(0, dst, x.index_select(0, src))
    return out


def _bump(stream, sig, slots):
    return counter_bump(sig, _counter_update(stream, slots, sig.shape[1]))


def _emit_completion_signal(stream, node, st):
    """§3.2 chained completion signal of a put descriptor: a wire signal
    (its own permuted one-hot put) and a local bump tied to the payload's
    arrival land the same counts — each branch's arrival mask in its
    slot (a multicast put's completion tree has several branches)."""
    ch = node.chained
    branches = ch.slots or ((ch.slot, node.direction),)
    st[ch.counter] = _bump(stream, st[ch.counter], branches)
    return st


def emit_node(stream, node, st, *, with_chained=True):
    """Apply one descriptor's state effect to the state dict ``st``
    (rebinding keys to new tensors). Shared by every executor."""
    if node.kind == "kernel":
        outs = node.fn(*[st[r] for r in node.reads])
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        for w, o in zip(node.writes, outs):
            st[w] = o
    elif node.kind == "signal" and node.role == "post":
        # merged signal kernel (paper §5.4): one bump for all peers
        slots = (node.slots if node.fused
                 else ((node.slot, node.direction),))
        st[node.counter] = _bump(stream, st[node.counter], slots)
    elif node.kind == "put":
        packed = len(node.srcs) > 1
        chunked = node.chunk_count > 1
        if chunked:
            # one CHUNK of a pipelined chain (schedule.chunk_puts): only
            # this chunk's element slice of the logical flat payload
            parts = ([st[s] for s in node.srcs] if packed
                     else [st[node.src]])
            payload = chunk_gather(parts, node.chunk_offset,
                                   node.chunk_elems)
        elif packed:
            # packed multi-buffer descriptor (schedule.pack_puts): one
            # staging buffer, one permuted copy, split on arrival
            payload = pack_flat([st[s] for s in node.srcs])
        else:
            payload = st[node.src]
        if node.mcast_dirs:
            raise NotImplementedError(
                "multicast puts come with the broadcast pattern, not "
                "ported yet (ROADMAP Queue 1 item 6)")
        arrived = _ppermute(stream, payload, node.direction)
        if chunked:
            dnames = node.dsts if packed else (node.dst,)
            updated = chunk_scatter(arrived, [st[d] for d in dnames],
                                    node.chunk_offset, node.chunk_elems)
            for dname, new in zip(dnames, updated):
                st[dname] = new
        elif packed:
            for dst, part in zip(
                    node.dsts,
                    unpack_flat(arrived, [st[d] for d in node.dsts])):
                st[dst] = part
        else:
            st[node.dst] = arrived
        if with_chained and node.chained is not None:
            st = _emit_completion_signal(stream, node, st)
    elif node.kind in ("start", "complete", "wait"):
        # start snapshots the post counter and wait fences the delivered
        # buffers: with in-order execution on one stream, the emission
        # order already gives both, so they move no data
        pass
    else:
        raise ValueError(f"cannot emit node kind {node.kind!r}")
    return st


# ---------------------------------------------------------------------------
# fused executor: one emission unit per planned segment
# ---------------------------------------------------------------------------

def run_fused(stream, prog, state):
    """Execute a fused-scheduled program through the progress engine:
    the planner's segments are the emission units, emitted in wave order
    (segments sorted by (wave, stream)), each segment's descriptor run
    emitted whole — a topological order, since every cross-stream edge
    points to a strictly earlier wave. ``stream.dispatches`` counts one
    unit per segment, the cost simulator's accounting unit (for a
    program scheduled with ``fused=True`` exactly
    ``throttle.host_dispatch_count(prog)``). The emission itself is still
    eager: the host launches every op of a segment on its own, so this
    executor issues as many device launches as ``run_compiled``; one
    launch per segment needs a persistent segment kernel or a CUDA graph
    (ROADMAP Queue 1 items 11 and 13). Programs scheduled without
    ``fused=True`` are planned here."""
    plan = prog.meta.get("segment_plan")
    if plan is None:
        from repro_torch.core.schedule import plan_segments
        plan = plan_segments(prog)
    by_id = {n.op_id: n for n in prog.nodes}
    st = dict(state)
    for seg in plan.segments:
        stream.dispatches += 1
        for oid in seg.op_ids:
            st = emit_node(stream, by_id[oid], st)
    return st
