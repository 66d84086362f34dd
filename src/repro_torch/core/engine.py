"""Descriptor emission (shared by every executor) and the fused executor.

:func:`emit_node` applies one scheduled descriptor's state effect with
PyTorch ops and the port's kernels; ``run_compiled`` and ``run_host``
(:mod:`repro_torch.core.backends`) and :func:`run_fused` below all emit
through it (on the card, ``run_compiled`` and ``run_fused`` emit while a
CUDA graph captures: :mod:`repro_torch.core.graphs`). The cost simulator in
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
  * every counter effect is ``sig + upd``, where ``upd`` is a precomputed
    (R, npeers) update holding each branch's arrival mask in its slot.
    Counters are integers, so this equals the JAX package's per-slot adds
    exactly. A post signal, fused or not, is ONE counter bump (the
    hand-written kernel on CUDA). A put's chained completion signal, wire
    or local, lands in the SAME launch as the put's permuted copy
    (``put_signal``): the signal's only readers are later launches on the
    same stream, which see the payload too. A multicast put (the JAX
    package's one ``ppermute`` per branch plus the completion tree) is ONE
    launch too (``put_multicast``): the payload read once, every branch's
    landing buffer written, and the tree's update over all branch slots.
    Only the host-orchestrated baseline (``backends.run_host``) keeps the
    completion a bump of its own, as the MPI runtime's completion
    handling is.

Index tensors, masks and counter updates are device tables built once
per direction (and per multicast branch set) when the stream allocates
its state (:func:`prepare_tables`), so emission copies nothing from the
host.

Nothing here writes into a tensor that a state key may alias: every
effect rebinds the key to a new tensor (the only in-place op fills a
freshly allocated put destination), so a state dict handed to an
executor is never modified and views (``unpack_flat``, the chunk
helpers) can share storage safely.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from repro_torch.core import graphs
from repro_torch.core.spans import span
from repro_torch.kernels.counter_bump.ops import (counter_bump,
                                                  put_multicast, put_signal,
                                                  rank_rows)
from repro_torch.kernels.halo_pack.ref import (chunk_gather, chunk_scatter,
                                               pack_flat, unpack_flat)

# ---------------------------------------------------------------------------
# device tables (built once per stream, before any emission)
# ---------------------------------------------------------------------------


def _perm_index(stream, direction):
    """(R,) int64 device table of a put in ``direction``: entry ``dst`` is
    the rank whose payload ``dst`` receives, -1 where none does (the
    non-receivers of a non-periodic grid, which get zeros)."""
    key = ("perm", tuple(direction))
    t = stream._device_tables.get(key)
    if t is None:
        idx = np.full((stream.num_ranks,), -1, np.int64)
        for src, dst in stream.perm_for(tuple(direction)):
            idx[dst] = src
        t = torch.as_tensor(idx, device=stream.device)
        stream._device_tables[key] = t
    return t


def _mcast_index(stream, directions):
    """(nb, R) int64 device table of a multicast put: row ``b`` is the
    :func:`_perm_index` of branch direction ``directions[b]``."""
    dirs = tuple(tuple(d) for d in directions)
    key = ("mcast", dirs)
    t = stream._device_tables.get(key)
    if t is None:
        t = torch.stack([_perm_index(stream, d) for d in dirs])
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
    the merged post update of the whole group; and for each multicast put
    enqueued on the stream, its branch table and its completion tree's
    update (the branches' slots, as lowering orders them)."""
    for win in stream.windows.values():
        npeers = max(len(win.group), 1)
        merged = []
        for d in win.group:
            slot = win.opposite_index(d)
            _perm_index(stream, d)
            _counter_update(stream, ((slot, tuple(d)),), npeers)
            merged.append((slot, tuple(d)))
        _counter_update(stream, tuple(merged), npeers)
    for op in stream.program:
        if op.kind == "put" and "directions" in op.put:
            win, dirs = op.window, op.put["directions"]
            _mcast_index(stream, dirs)
            _counter_update(stream,
                            tuple((win.opposite_index(d), tuple(d))
                                  for d in dirs),
                            max(len(win.group), 1))


# ---------------------------------------------------------------------------
# emission
# ---------------------------------------------------------------------------

def _bump(stream, sig, slots):
    return counter_bump(sig, _counter_update(stream, slots, sig.shape[1]))


def _completion_slots(node):
    """(slot, direction) branches of a put's §3.2 chained completion
    signal: a wire signal (its own permuted one-hot put) and a local bump
    tied to the payload's arrival land the same counts — each branch's
    arrival mask in its slot (a multicast put's completion tree has
    several branches)."""
    ch = node.chained
    return ch.slots or ((ch.slot, node.direction),)


def _emit_completion_signal(stream, node, st):
    """A put's chained completion signal as a bump of its own."""
    st[node.chained.counter] = _bump(stream, st[node.chained.counter],
                                     _completion_slots(node))
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
        if not payload.is_contiguous() and rank_rows(payload) is None:
            # an unmerged pack's strided surface view: the puts copy rows
            # whose elements are contiguous
            payload = payload.contiguous()
        ch = node.chained if with_chained else None
        if node.mcast_dirs:
            # multicast descriptor: ONE launch reads the payload once and
            # writes every branch's landing buffer (and, chained, the
            # completion tree over every branch's slot)
            perms = _mcast_index(stream, node.mcast_dirs)
            if ch is None:
                arrivals = put_multicast(payload, perms)
            else:
                cnt = st[ch.counter]
                arrivals, st[ch.counter] = put_multicast(
                    payload, perms, cnt, _counter_update(
                        stream, _completion_slots(node), cnt.shape[1]))
            for dname, arrived in zip(node.dsts, arrivals):
                if chunked:
                    st[dname], = chunk_scatter(arrived, [st[dname]],
                                               node.chunk_offset,
                                               node.chunk_elems)
                else:
                    st[dname] = arrived
            return st
        perm = _perm_index(stream, node.direction)
        if ch is None:
            arrived = put_signal(payload, perm)
        else:
            # the payload and its completion signal in one launch
            cnt = st[ch.counter]
            arrived, st[ch.counter] = put_signal(
                payload, perm, cnt, _counter_update(
                    stream, _completion_slots(node), cnt.shape[1]))
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
    elif node.kind in ("start", "complete", "wait"):
        # start snapshots the post counter and wait fences the delivered
        # buffers: with in-order execution on one stream, the emission
        # order already gives both, so they move no data
        pass
    else:
        raise ValueError(f"cannot emit node kind {node.kind!r}")
    return st


# ---------------------------------------------------------------------------
# the program graphs of the st and fused executors
# ---------------------------------------------------------------------------

def program_graph(stream, cache, prog, state, name, segments):
    """The :class:`~repro_torch.core.graphs.ProgramGraph` of ``prog`` on
    a state like ``state``, from ``cache`` (one of the stream's graph
    caches) or made from ``segments()`` (its emission functions). Keyed
    by ``prog.key()``, computed once per program object, and each state
    key's shape, dtype and stride."""
    memo = stream._program_keys.get(id(prog))
    if memo is None:            # the entry holds prog: its id stays its own
        memo = stream._program_keys[id(prog)] = (prog, prog.key())
    key = (memo[1], tuple(state), graphs.tensor_key(list(state.values())))
    g = cache.get(key)
    if g is None:
        g = cache[key] = graphs.ProgramGraph(name, segments())
    return g


# ---------------------------------------------------------------------------
# fused executor: one emission unit per planned segment
# ---------------------------------------------------------------------------

def _segment_nodes(prog):
    """Each planned segment's descriptors, in wave order."""
    plan = prog.meta.get("segment_plan")
    if plan is None:
        from repro_torch.core.schedule import plan_segments
        plan = plan_segments(prog)
    by_id = {n.op_id: n for n in prog.nodes}
    return [[by_id[oid] for oid in seg.op_ids] for seg in plan.segments]


def _emit_segment(stream, nodes, state):
    st = dict(state)
    for node in nodes:
        st = emit_node(stream, node, st)
    return st


def _emit_fused(stream, prog, state):
    """The fused program emitted eagerly, segment by segment in wave
    order: what :func:`run_fused` captures, the CPU route, and the
    yardstick the graphs are held to on the card."""
    st = dict(state)
    for nodes in _segment_nodes(prog):
        st = _emit_segment(stream, nodes, st)
    return st


def run_fused(stream, prog, state):
    """Execute a fused-scheduled program through the progress engine:
    the planner's segments are the emission units, in wave order
    (segments sorted by (wave, stream)), each segment's descriptor run
    emitted whole — a topological order, since every cross-stream edge
    points to a strictly earlier wave. On the card each segment is one
    CUDA graph, captured at the program's first run in wave order into
    one shared memory pool and cached on the stream as ``_fused_cache``
    (the JAX package's per-program executable), so the host launches
    exactly one graph per segment: for a program scheduled with
    ``fused=True``, ``throttle.host_dispatch_count(prog)`` graphs, the
    simulator's charge. ``stream.dispatches`` counts those units. On the
    CPU the segments are emitted eagerly (:func:`_emit_fused`). Programs
    scheduled without ``fused=True`` are planned here."""
    if not graphs.applies(stream.device):
        stream.dispatches += len(_segment_nodes(prog))
        return _emit_fused(stream, prog, state)
    # the graphs, held by the stream, hold the stream weakly
    ref = weakref.proxy(stream)
    with span("repro_torch.st.lookup"):
        g = program_graph(
            stream, stream._fused_cache, prog, state,
            f"the fused program ({len(prog.nodes)} descriptors)",
            lambda: [lambda st, nodes=nodes: _emit_segment(ref, nodes, st)
                     for nodes in _segment_nodes(prog)])
    stream.dispatches += len(g.segments)
    return g(state)
