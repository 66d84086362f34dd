"""Stage 2 — schedule passes: pure graph transforms on the descriptor DAG.

Each pass takes a :class:`TriggeredProgram` fresh from lowering and
rewrites nodes/edges; none of them touch torch or device state, so the
exact schedule the executors emit is also the schedule the simulator
walks (the benchmark "derived" column can no longer drift from the code
that runs).

Passes
  * :func:`fuse_signals`  — merged-signal-kernel fusion (paper §5.4):
    collapse per-neighbor "post" signal descriptors into ONE fused
    descriptor per window, and turn each put's §3.2 chained wire signal
    into a local counter bump tied to the payload's arrival.
  * :func:`ordering_pass` — P2P message-matching semantics (paper §4.3 /
    §7(1)): serialize every put on the previous put's completion.
  * :func:`throttle_pass` — finite triggered-op slots (paper §5.2):
      - "adaptive"  (§5.2.3): put i depends on completion of put i-R,
        the sliding-window recapture of the oldest slot;
      - "static"    (§5.2.2): epoch e puts depend on ALL epoch e-1
        completions, and when an epoch alone exhausts the R slots the
        runtime's weak sync fires: the next put depends on ALL puts of
        the previous R-window. Static's dependency set therefore
        contains adaptive's — the derived times order the way Fig. 13
        does by construction;
      - "application" (§5.2.1) places no edges here — it is expressed as
        host_sync() program splits at lowering time;
      - "none" places no edges (infinite slots).
    Always records the ResourcePool high-water mark in program meta.
  * :func:`pack_puts` — materialized put aggregation (companion
    triggered-ops paper, arXiv:2208.04817): dependency-free off-node
    puts of an epoch sharing one rank permutation merge into ONE packed
    multi-buffer descriptor — one staging pack, one collective, one
    chained completion signal, one NIC injection. Runs before
    throttling so the finite descriptor slots count PACKED descriptors.
  * :func:`chunk_puts` — chunked-pipelined transport: any off-node put
    whose payload exceeds ``chunk_bytes`` is rewritten into a CHAIN of
    chunk descriptors (contiguous element slices of the logical flat
    payload), each with its own chained completion signal, and NO
    dependency edges between the chunks — the NIC injection timeline
    serializes them naturally, so pack(k+1) overlaps wire(k) overlaps
    unpack(k-1) and only the first chunk pays the per-message alpha.
    Runs after pack_puts (packed descriptors chunk over their staging
    concat) and before throttle_pass (slots hold chunk descriptors).
  * :func:`node_aware_pass` — topology-aware put ordering: within each
    epoch's put run, off-node ("inter"-link) puts issue FIRST so their
    long latency and serialized NIC injection overlap the on-node puts
    and compute; ``coalesce`` marks adjacent same-target-node off-node
    puts as aggregated (an ordering/bookkeeping hint — since pack_puts
    materialized real aggregation, the marking carries no cost
    discount). Dependency edges are never crossed, so the executors
    stay bit-identical.
  * :func:`assign_streams` — multi-stream overlap (paper §2/§6.7: the
    separate communication stream is what lets the NIC move epoch e+1's
    bytes while the device computes epoch e): partition the DAG onto a
    compute stream (stream 0, all kernels) and one or more communication
    streams (post/start/put/complete/wait, round-robin by epoch).
    Program order is kept only WITHIN a stream; every cross-stream
    ordering the single-stream program encoded positionally becomes an
    explicit dependency edge derived from buffer conflicts (RAW/WAR/WAW
    on window buffers and counters), so any emission order that respects
    the edges — see :func:`stream_interleaved_order` — reproduces the
    single-stream values bit-for-bit.
  * :func:`validate_deps` — every dependency edge must name an op_id of
    a node in the same program; dangling edges (e.g. referencing a put
    in a previous host_sync segment) raise here instead of being
    silently treated as complete by the simulator.
  * :func:`plan_segments` — segment planning for the device-resident
    progress engine (``fused=True``): partition the scheduled DAG into
    per-stream SEGMENTS — maximal runs of consecutive same-stream
    descriptors with no cross-stream dependency edge entering mid-run —
    and assign every buffer/counter each segment touches a static
    offset in a per-segment device arena. The engine
    (:mod:`repro_torch.core.engine`) lowers each segment into ONE fused
    emission unit; the host's only job is launch.

:func:`schedule` applies the passes in order.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, FrozenSet, Tuple

import numpy as np

from repro_torch.core.dtypes import dtype_size
from repro_torch.core.triggered import (ResourcePool, TriggeredOp,
                                        TriggeredProgram)

THROTTLE_POLICIES = ("adaptive", "static", "application", "none")


def fuse_signals(prog: TriggeredProgram, merged: bool) -> TriggeredProgram:
    """Merged-signal-kernel fusion (paper §5.4)."""
    prog.meta["merged"] = merged
    if not merged:
        return prog
    fused_nodes = []
    i = 0
    nodes = prog.nodes
    while i < len(nodes):
        n = nodes[i]
        if n.kind == "signal" and n.role == "post" and not n.fused:
            j = i
            group = []
            while (j < len(nodes) and nodes[j].kind == "signal"
                   and nodes[j].role == "post"
                   and nodes[j].window == n.window
                   and nodes[j].counter == n.counter):
                group.append(nodes[j])
                j += 1
            fused_nodes.append(TriggeredOp(
                "signal", window=n.window, role="post", counter=n.counter,
                fused=True, epoch=n.epoch, phase=n.phase,
                slots=tuple((g.slot, g.direction) for g in group),
                label=f"post_merged[{len(group)}]"))
            i = j
        else:
            fused_nodes.append(n)
            i += 1
    for n in fused_nodes:
        if n.kind == "put" and n.chained is not None:
            # merged completion: the arrived payload IS the
            # completion event at the target — bump the target counter
            # locally, tied to arrival, instead of a second wire signal.
            # Saves one tiny collective per put (26/iteration in Faces).
            n.chained.wire = False
            n.chained.fused = True
    prog.nodes = fused_nodes
    return prog


def ordering_pass(prog: TriggeredProgram, ordered: bool) -> TriggeredProgram:
    """P2P message-matching: chain each put on its predecessor."""
    prog.meta["ordered"] = ordered
    if not ordered:
        return prog
    prev = None
    for n in prog.nodes:
        if n.kind == "put":
            if prev is not None:
                n.deps += (prev,)
            prev = n.op_id
    return prog


def throttle_pass(prog: TriggeredProgram, policy: str,
                  resources: int) -> TriggeredProgram:
    """Throttling as dependency edges over finite descriptor slots."""
    if policy not in THROTTLE_POLICIES:
        raise ValueError(f"unknown throttle policy {policy!r}; "
                         f"expected one of {THROTTLE_POLICIES}")
    # pool reclaim mirrors each policy so the high-water mark is the
    # number of descriptor slots the schedule actually holds in flight:
    # adaptive recaptures the oldest slot per put past capacity; static
    # reclaims whole windows at its barriers; none/application never
    # reclaim within a segment.
    unbounded = policy in ("none", "application")
    pool = ResourcePool(capacity=(1 << 30) if unbounded else resources)
    puts = prog.puts()
    by_epoch = defaultdict(list)
    for p in puts:
        by_epoch[p.epoch].append(p.op_id)
    put_ids = [p.op_id for p in puts]
    prev_epoch = None
    for i, p in enumerate(puts):
        if policy == "static":
            barrier = (i >= resources and i % resources == 0)
            if p.epoch != prev_epoch or barrier:
                pool.release_all()   # epoch barrier / §5.2.2 weak sync
            prev_epoch = p.epoch
            if p.epoch >= 1:
                p.deps += tuple(by_epoch.get(p.epoch - 1, ()))
            if barrier:
                # weak sync inside the runtime (§5.2.2): reclaim the
                # whole exhausted R-window before posting more
                p.deps += tuple(put_ids[i - resources:i])
        blocker = pool.acquire(p.op_id)
        if policy == "adaptive" and blocker is not None:
            p.deps += (blocker,)
    for p in puts:
        p.deps = tuple(dict.fromkeys(p.deps))   # dedupe, keep order
    prog.meta["throttle"] = policy
    # unbounded policies hold no descriptor slots: there is no real R to
    # report (None renders as "—" in launch/report), only the high-water
    # mark of what the schedule actually kept in flight
    prog.meta["resources"] = None if unbounded else resources
    prog.meta["resource_high_water"] = pool.high_water
    return prog


# ---------------------------------------------------------------------------
# put aggregation: packed multi-buffer descriptors
# ---------------------------------------------------------------------------

def _pack_run(run, windows, remap, groups_meta):
    """Pack one epoch's put run: dependency-free off-node ("inter") puts
    sharing the SAME rank permutation, parity, and source dtype merge
    into ONE packed multi-buffer descriptor (the head keeps its op_id
    and chained signal; the tails' op_ids are recorded in ``remap`` so
    later dependency edges re-point at the head). Dependency-gated puts
    are never merged and stay last in their original order (exactly the
    :func:`_off_node_first` argument: their in-run edges are already
    satisfied there), so two puts connected by a dependency edge never
    collapse into one descriptor. On-node puts stay unpacked: the xGMI
    fabric moves them in parallel, so serializing their bandwidth into
    one message could only lose; aggregation is a NIC-descriptor
    feature (paper §3 / arXiv:2208.04817)."""
    in_run = {p.op_id for p in run}
    free = [p for p in run if not any(d in in_run for d in p.deps)]
    gated = [p for p in run if any(d in in_run for d in p.deps)]
    groups: dict = {}
    order = []
    for p in free:
        # multicast descriptors carry no perm (one payload, many branch
        # permutations) and therefore always stay solo
        if p.link != "inter" or not p.perm:
            key = ("solo", p.op_id)
        else:
            key = (p.phase % 2, p.perm, p.dtype)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(p)
    packed = []
    for key in order:
        g = groups[key]
        head = g[0]
        if len(g) > 1:
            head.srcs = tuple(p.src for p in g)
            head.dsts = tuple(p.dst for p in g)
            head.nbytes = sum(p.nbytes for p in g)
            deps = []
            for p in g:
                deps.extend(p.deps)
            head.deps = tuple(dict.fromkeys(deps))
            win = windows.get(head.window)
            staging = (win.pack_staging(head.epoch, head.phase, len(g))
                       if win is not None else f"{head.window}.__pack")
            head.label = f"packed_put{tuple(head.direction)}[{len(g)}]"
            if head.chained is not None:
                # ONE chained completion signal stands for the whole
                # group: the packed payload is one message, one arrival
                head.chained.label = (f"comp_packed"
                                      f"{tuple(head.direction)}[{len(g)}]")
            for p in g[1:]:
                remap[p.op_id] = head.op_id
            groups_meta.append({"head": head.op_id, "staging": staging,
                                "members": [p.op_id for p in g],
                                "nbytes": head.nbytes})
        packed.append(head)
    return packed + gated


def pack_puts(prog: TriggeredProgram, pack: bool = True) -> TriggeredProgram:
    """Materialized put aggregation (the companion triggered-ops paper's
    aggregated descriptors, arXiv:2208.04817): rewrite each coalescible
    group of an epoch — ring's K,V pair, a2a's partial+aux per shift,
    same-permutation multi-face halo groups — into ONE packed TriggeredOp
    that packs its payloads into one contiguous staging buffer, rides one
    collective, and lands one chained completion signal for the whole
    group. Runs BEFORE throttle_pass on purpose: the NIC's finite
    triggered-op slots hold DESCRIPTORS, so packing directly reduces
    descriptor pressure (fewer throttle edges), host dispatches
    (run_host issues one dispatch per group), and emitted collectives
    (run_compiled traces pack -> single ppermute -> unpack).

    Wait nodes' ``expected_puts`` are recounted per descriptor and every
    dependency edge naming a merged-away tail is re-pointed at its
    group's head, so validate_deps and the simulator's completion-count
    check keep holding on the packed program."""
    prog.meta["pack"] = bool(pack)
    if not pack:
        return prog
    out = []
    remap: dict = {}
    groups_meta: list = []
    nodes = prog.nodes
    i = 0
    while i < len(nodes):
        n = nodes[i]
        if n.kind != "put":
            out.append(n)
            i += 1
            continue
        j = i
        while (j < len(nodes) and nodes[j].kind == "put"
               and nodes[j].window == n.window
               and nodes[j].epoch == n.epoch):
            j += 1
        out.extend(_pack_run(nodes[i:j], prog.windows, remap, groups_meta))
        i = j
    if remap:
        for n in out:
            if n.deps:
                n.deps = tuple(dict.fromkeys(
                    remap.get(d, d) for d in n.deps))
    prog.nodes = out
    counts: dict = {}
    for n in out:
        if n.kind == "put":
            k = (n.window, n.epoch)
            counts[k] = counts.get(k, 0) + 1
    for n in out:
        if n.kind == "wait" and n.expected_puts >= 0:
            n.expected_puts = counts.get((n.window, n.epoch), 0)
    prog.meta["packed_groups"] = groups_meta
    return prog


# ---------------------------------------------------------------------------
# chunked-pipelined transport: split large puts into chunk chains
# ---------------------------------------------------------------------------

def _clone_chained(c0, k):
    """Tail chunk's own chained completion signal — a structural copy of
    the head's (post-fusion, so ``wire``/``fused`` are already resolved):
    every chunk's arrival bumps the same counter slot(s), and the wait's
    ``expected_puts`` is recounted per chunk to match."""
    return TriggeredOp(
        "signal", window=c0.window, role="completion",
        direction=c0.direction, slot=c0.slot, slots=c0.slots,
        fused=c0.fused, wire=c0.wire, counter=c0.counter,
        epoch=c0.epoch, phase=c0.phase, label=f"{c0.label}#c{k}")


def chunk_puts(prog: TriggeredProgram,
               chunk_bytes: int = 0) -> TriggeredProgram:
    """Chunked-pipelined transport: rewrite any off-node put whose
    payload exceeds ``chunk_bytes`` into a chain of chunk descriptors.

    Each chunk is a contiguous ELEMENT slice of the put's logical flat
    payload (for a packed descriptor: the staging concat of its group),
    carrying the head's buffers/permutation/trigger plus its own chained
    completion signal. The head mutates in place and keeps its op_id —
    chunk 0 of the chain — so existing dependency edges stay valid;
    edges naming a chunked put are then WIDENED with the tail op_ids
    (depending on a put means "payload fully delivered" = all chunks).
    Chunks carry NO dependency edges on each other: serializing them
    would forfeit the pipelining — the rank's NIC injection timeline
    (and, in the executors, emission order on the issuing stream) keeps
    them ordered, while chunks of DIFFERENT puts interleave freely.
    Only the first chunk pays the per-message alpha in the cost model;
    every chunk pays its own beta and ``t_issue``.

    On-node ("intra") puts never chunk, mirroring pack_puts: pipelined
    chunking is a NIC-descriptor feature; the xGMI fabric moves on-node
    payloads in parallel already. ``wait.expected_puts`` is recounted
    per chunk so the simulator's completion accounting still catches
    every lost signal."""
    prog.meta["chunk_bytes"] = int(chunk_bytes)
    if chunk_bytes <= 0:
        return prog
    out: list = []
    groups_meta: list = []
    tails_of: dict = {}                    # head op_id -> tail op_ids
    for n in prog.nodes:
        if (n.kind != "put" or n.link != "inter" or not n.dtype
                or n.nbytes <= chunk_bytes):
            out.append(n)
            continue
        itemsize = dtype_size(n.dtype)
        total = n.nbytes // itemsize
        per = max(1, int(chunk_bytes) // itemsize)
        nchunks = -(-total // per)
        base_label = n.label
        n.chunk_index, n.chunk_count = 0, nchunks
        n.chunk_offset, n.chunk_elems = 0, min(per, total)
        n.chunk_head = n.op_id
        n.nbytes = n.chunk_elems * itemsize
        n.label = f"{base_label}#c0/{nchunks}"
        if n.chained is not None:
            n.chained.label = f"{n.chained.label}#c0"
        out.append(n)
        tails = []
        for k in range(1, nchunks):
            off = k * per
            cnt = min(per, total - off)
            t = TriggeredOp(
                "put", window=n.window, src=n.src, dst=n.dst,
                srcs=n.srcs, dsts=n.dsts, direction=n.direction,
                mcast_dirs=n.mcast_dirs, nbytes=cnt * itemsize,
                dtype=n.dtype, perm=n.perm, link=n.link,
                node_deltas=n.node_deltas, epoch=n.epoch, phase=n.phase,
                trigger_counter=n.trigger_counter, threshold=n.threshold,
                completion_counter=n.completion_counter,
                chained=(_clone_chained(n.chained, k)
                         if n.chained is not None else None),
                deps=tuple(n.deps), chunk_index=k, chunk_count=nchunks,
                chunk_offset=off, chunk_elems=cnt, chunk_head=n.op_id,
                label=f"{base_label}#c{k}/{nchunks}")
            tails.append(t)
            out.append(t)
        tails_of[n.op_id] = tuple(t.op_id for t in tails)
        win = prog.windows.get(n.window)
        staging = (win.chunk_staging(n.epoch, n.phase, nchunks)
                   if win is not None else f"{n.window}.__chunk")
        groups_meta.append({"head": n.op_id, "staging": staging,
                            "chunks": nchunks, "elems": total,
                            "members": [n.op_id]
                            + [t.op_id for t in tails]})
    if tails_of:
        for n in out:
            if n.deps and any(d in tails_of for d in n.deps):
                deps = []
                for d in n.deps:
                    deps.append(d)
                    deps.extend(tails_of.get(d, ()))
                n.deps = tuple(dict.fromkeys(deps))
    prog.nodes = out
    counts: dict = {}
    for n in out:
        if n.kind == "put":
            k = (n.window, n.epoch)
            counts[k] = counts.get(k, 0) + 1
    for n in out:
        if n.kind == "wait" and n.expected_puts >= 0:
            n.expected_puts = counts.get((n.window, n.epoch), 0)
    prog.meta["chunked_groups"] = groups_meta
    return prog


# ---------------------------------------------------------------------------
# node-aware ordering (off-node transfers first, optional aggregation)
# ---------------------------------------------------------------------------

def _off_node_first(run):
    """Stable node-aware order of one epoch's put run: off-node
    ("inter") puts go first within each dependency-free burst (they can
    inject into the NIC command queue immediately — issuing them early
    is the whole win). A dependency-gated put is a BARRIER the reorder
    never crosses: (a) the original order already satisfies its in-run
    edges, (b) a gated put enqueued early would head-of-line block the
    NIC behind a transfer that cannot start yet, and (c) a throttle
    gate (static weak sync / adaptive slot-recapture edge) bounds the
    descriptors in flight only while every put that FOLLOWED it keeps
    following it — hoisting free puts across the gate would let the
    schedule hold more slots than the policy's ``resources`` claims
    (the static verifier's resource-safety pass proves the bound per
    schedule). Two puts connected by a dependency edge never swap."""
    in_run = {p.op_id for p in run}
    out, burst = [], []

    def flush():
        out.extend(p for p in burst if p.link == "inter")
        out.extend(p for p in burst if p.link != "inter")
        burst.clear()

    for p in run:
        if any(d in in_run for d in p.deps):
            flush()
            out.append(p)
        else:
            burst.append(p)
    flush()
    return out


def node_aware_pass(prog: TriggeredProgram, node_aware: bool = True,
                    coalesce: bool = False) -> TriggeredProgram:
    """Node-aware put ordering (the node-aware-strategies lever for the
    paper's off-node gap): within each epoch's put run, issue off-node
    ("inter") puts FIRST so their long wire latency and serialized NIC
    injection overlap the epoch's remaining on-node puts and compute —
    never reordering across a dependency edge, so both executors stay
    bit-identical to the naive order (same DAG, different emission
    order). ``coalesce`` additionally marks the tail puts of adjacent
    same-target-node ("node_deltas") off-node groups as ``aggregated``
    — a bookkeeping/ordering hint identifying coalescible runs. The
    marking carries NO cost discount: materialized aggregation
    (pack_puts) replaced the simulator-only alpha waiver, so the cost
    model prices every real message's alpha."""
    prog.meta["node_aware"] = bool(node_aware)
    prog.meta["coalesce"] = bool(coalesce)
    if not node_aware:
        return prog
    out: list = []
    nodes = prog.nodes
    i = 0
    while i < len(nodes):
        n = nodes[i]
        if n.kind != "put":
            out.append(n)
            i += 1
            continue
        j = i
        while (j < len(nodes) and nodes[j].kind == "put"
               and nodes[j].window == n.window
               and nodes[j].epoch == n.epoch):
            j += 1
        out.extend(_off_node_first(nodes[i:j]))
        i = j
    prog.nodes = out
    if coalesce:
        # packed multi-buffer descriptors (pack_puts) and chunk/multicast
        # descriptors (chunk_puts / put_multicast) are MATERIALIZED
        # transport shapes — each a real wire message — so they neither
        # receive the aggregated marking nor anchor a marked group
        prev = None
        for n in prog.nodes:
            packed = n.kind == "put" and (len(n.srcs) > 1
                                          or n.chunk_count > 1
                                          or bool(n.mcast_dirs))
            if (n.kind == "put" and not packed and prev is not None
                    and n.link == "inter" and prev.link == "inter"
                    and n.window == prev.window and n.epoch == prev.epoch
                    and n.node_deltas == prev.node_deltas):
                n.aggregated = True
            prev = n if n.kind == "put" and not packed else None
    return prog


# ---------------------------------------------------------------------------
# stream assignment (multi-stream overlap)
# ---------------------------------------------------------------------------

def _accesses(n: TriggeredOp):
    """(reads, writes) state-buffer sets of one descriptor — the conflict
    footprint assign_streams turns into cross-stream dependency edges.
    Counter bumps are read-modify-write; a wait reads its completion
    counter and fences (reads+writes) the buffers its epoch's puts
    delivered (node.writes from lowering) — NOT the window's compute
    state, which stays free to overlap."""
    if n.kind == "kernel":
        return set(n.reads), set(n.writes)
    if n.kind == "signal":
        return {n.counter}, {n.counter}
    if n.kind == "start":
        return {n.counter}, set()
    if n.kind == "put":
        # a packed multi-buffer descriptor reads/writes its WHOLE group
        reads = set(n.srcs) if n.srcs else {n.src}
        writes = set(n.dsts) if n.dsts else {n.dst}
        if n.chained is not None:
            reads.add(n.chained.counter)
            writes.add(n.chained.counter)
        return reads, writes
    if n.kind == "wait":
        fence = set(n.writes)
        return {n.counter} | fence, fence
    return set(), set()          # "complete" is a marker


def assign_streams(prog: TriggeredProgram,
                   nstreams: int = 1) -> TriggeredProgram:
    """Partition the DAG onto a compute stream and communication streams.

    Kernels stay on stream 0; every protocol/transfer descriptor of epoch
    e moves to communication stream ``1 + e % (nstreams-1)``. Ordering
    between two ops is kept ONLY when they share a stream (program order)
    — every cross-stream conflict (RAW/WAR/WAW on a buffer or counter)
    becomes an explicit dependency edge, so emission order and the
    simulator's per-stream timelines can overlap everything else."""
    nstreams = max(1, int(nstreams))
    prog.meta["nstreams"] = nstreams
    for n in prog.nodes:
        n.stream = 0
    if nstreams == 1:
        return prog
    ncomm = nstreams - 1
    for n in prog.nodes:
        if n.kind != "kernel":
            n.stream = 1 + (n.epoch % ncomm)

    last_writer = {}                       # buffer -> op_id
    readers = defaultdict(list)            # buffer -> op_ids since write
    stream_of = {}
    for n in prog.nodes:
        reads, writes = _accesses(n)
        edges = []
        for b in sorted(reads | writes):
            w = last_writer.get(b)
            if w is not None and stream_of[w] != n.stream:
                edges.append(w)
        for b in sorted(writes):
            for r in readers[b]:
                if stream_of[r] != n.stream:
                    edges.append(r)
        if edges:
            n.deps = tuple(dict.fromkeys(n.deps + tuple(edges)))
        stream_of[n.op_id] = n.stream
        for b in writes:
            last_writer[b] = n.op_id
            readers[b] = []
        for b in reads:
            readers[b].append(n.op_id)
    return prog


def stream_interleaved_order(prog: TriggeredProgram):
    """Topological emission order interleaving the streams round-robin:
    within a stream program order is preserved; a node is emitted once
    every dependency edge it carries has been emitted. For single-stream
    programs this is exactly ``prog.nodes``."""
    streams = sorted({n.stream for n in prog.nodes})
    if len(streams) <= 1:
        return list(prog.nodes)
    queues = {s: [n for n in prog.nodes if n.stream == s] for s in streams}
    heads = {s: 0 for s in streams}
    emitted = set()
    order = []
    while len(order) < len(prog.nodes):
        progressed = False
        for s in streams:
            i = heads[s]
            if i >= len(queues[s]):
                continue
            node = queues[s][i]
            if all(d in emitted for d in node.deps):
                order.append(node)
                emitted.add(node.op_id)
                heads[s] = i + 1
                progressed = True
        if not progressed:
            # name a witness: among the stuck stream heads (and anything
            # unemitted behind them), each node waits for its unemitted
            # deps and its unemitted stream predecessor
            from repro_torch.core.verify import find_cycle

            stuck = {n.op_id: n for q in queues.values() for n in q
                     if n.op_id not in emitted}

            pos = {n.op_id: (s, i) for s, q in queues.items()
                   for i, n in enumerate(q)}

            def waiting_for(op_id):
                node = stuck[op_id]
                succ = [d for d in node.deps if d in stuck]
                s, i = pos[op_id]
                if i > 0 and queues[s][i - 1].op_id in stuck:
                    succ.append(queues[s][i - 1].op_id)
                return succ

            cyc = find_cycle(stuck, waiting_for)
            witness = " -> ".join(
                f"{stuck[i].kind}#{i}" for i in (cyc or [])) or \
                f"stuck heads: {sorted(stuck)[:8]}"
            raise RuntimeError(
                "stream_interleaved_order: cyclic or forward dependency "
                "edges — the schedule passes emitted a non-DAG "
                f"(witness cycle: {witness})")
    return order


def validate_deps(prog: TriggeredProgram) -> TriggeredProgram:
    """Every dependency edge must name an op_id present in this program,
    op_ids must be unique, and no op may depend on itself.

    A dangling edge (a put from a previous host_sync segment, or a buggy
    pass emitting a stale op_id) would otherwise be silently treated as
    completed-at-t0 by the simulator and as a no-op tie by the compiled
    executor; a duplicate op_id makes every edge naming it ambiguous,
    and a self-dependency can never fire."""
    known: set = set()
    dup = []
    for n in prog.nodes:
        if n.op_id in known:
            dup.append((n.kind, n.op_id))
        known.add(n.op_id)
    if dup:
        raise ValueError(
            f"duplicate op_ids: {dup[:5]}{'...' if len(dup) > 5 else ''}"
            " — dependency edges naming them are ambiguous")
    selfdep = [(n.kind, n.label or n.op_id)
               for n in prog.nodes if n.op_id in n.deps]
    if selfdep:
        raise ValueError(
            f"self-dependencies: {selfdep[:5]}"
            f"{'...' if len(selfdep) > 5 else ''} — an op gated on its "
            "own completion never fires")
    bad = [(n.kind, n.label or n.op_id, d)
           for n in prog.nodes for d in n.deps if d not in known]
    if bad:
        raise ValueError(
            "dangling dependency edges (op_ids not in this program): "
            f"{bad[:5]}{'...' if len(bad) > 5 else ''} — deps must name "
            "ops in the same host_sync segment")
    return prog


# ---------------------------------------------------------------------------
# segment planning (device-resident progress engine)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Segment:
    """One fused emission unit of the device-resident progress engine: a
    maximal run of CONSECUTIVE same-stream descriptors with no
    cross-stream dependency edge entering mid-run. ``wave`` is the
    segment's global launch level (every cross-stream edge points from a
    strictly earlier wave); ``arena`` assigns each window buffer and
    counter the segment touches a static, 64-byte-aligned byte offset in
    the segment's device arena (``arena_nbytes`` total), so the engine's
    counters/semaphores live at fixed addresses for the segment's whole
    lifetime — no per-op host bookkeeping."""
    stream: int
    wave: int
    op_ids: Tuple[int, ...]
    arena: Dict[str, int]
    arena_nbytes: int


@dataclass(frozen=True)
class SegmentPlan:
    """Full segment partition of one scheduled program.

    ``wave_of`` maps every op_id to its segment's wave; ``heads`` is the
    set of op_ids that OPEN a segment — the simulator charges host
    dispatch once per head (per-segment, not per-op) when the program is
    fused, and the verifier anchors its segment-boundary happens-before
    edges on them."""
    segments: Tuple[Segment, ...]
    wave_of: Dict[int, int]
    heads: FrozenSet[int]

    @property
    def waves(self) -> int:
        return 1 + max((s.wave for s in self.segments), default=-1)


def plan_segments(prog: TriggeredProgram) -> SegmentPlan:
    """Partition a scheduled program into per-stream segments.

    Wave/level fixpoint: every node starts at wave 0; a forward sweep in
    program order enforces (a) per-stream monotonicity (a node's wave is
    at least its stream's previous node's wave — segments are CONSECUTIVE
    runs) and (b) cross-stream edges advance the wave (a node depending
    on another stream's node lands at least one wave later, so the edge
    meets a segment BOUNDARY, never mid-run). Chunk-chain coherence then
    lifts every chunk of a chain to the chain's maximum wave — a chain
    never splits across segments (and by per-stream monotonicity the
    same-stream nodes interleaved between its chunks ride along into the
    same wave). Packed groups are ONE descriptor after pack_puts, so
    they cannot split by construction. The sweep repeats until no wave
    moves; waves only ever increase and are bounded by the node count,
    so the fixpoint terminates.

    Each segment's arena (static buffer/counter offsets) is laid out
    from its :func:`_accesses` footprint via
    :func:`repro_torch.core.lower.arena_layout`. The plan is recorded in
    ``prog.meta["segment_plan"]`` / ``meta["segments"]``."""
    from repro_torch.core.lower import arena_layout

    nodes = prog.nodes
    by_id = {n.op_id: n for n in nodes}
    level: Dict[int, int] = {n.op_id: 0 for n in nodes}
    chains: Dict[int, list] = defaultdict(list)
    for n in nodes:
        if n.kind == "put" and n.chunk_count > 1 and n.chunk_head >= 0:
            chains[n.chunk_head].append(n.op_id)
    changed = True
    while changed:
        changed = False
        last: Dict[int, int] = {}
        for n in nodes:
            lv = max(level[n.op_id], last.get(n.stream, 0))
            for d in n.deps:
                dn = by_id.get(d)
                if dn is not None and dn.stream != n.stream:
                    lv = max(lv, level[d] + 1)
            if lv != level[n.op_id]:
                level[n.op_id] = lv
                changed = True
            last[n.stream] = lv
        for members in chains.values():
            top = max(level[m] for m in members)
            for m in members:
                if level[m] != top:
                    level[m] = top
                    changed = True

    segments = []
    open_ops: Dict[int, list] = {}
    open_wave: Dict[int, int] = {}

    def close(stream: int) -> None:
        ops = open_ops.pop(stream, [])
        if not ops:
            return
        names: set = set()
        for oid in ops:
            reads, writes = _accesses(by_id[oid])
            names |= reads | writes
        names.discard(None)
        arena, nbytes = arena_layout(prog.windows, names)
        segments.append(Segment(stream=stream, wave=open_wave[stream],
                                op_ids=tuple(ops), arena=arena,
                                arena_nbytes=nbytes))

    for n in nodes:
        w = level[n.op_id]
        if n.stream in open_ops and open_wave[n.stream] != w:
            close(n.stream)
        open_ops.setdefault(n.stream, []).append(n.op_id)
        open_wave[n.stream] = w
    for s in list(open_ops):
        close(s)
    segments.sort(key=lambda s: (s.wave, s.stream))

    plan = SegmentPlan(segments=tuple(segments), wave_of=dict(level),
                       heads=frozenset(s.op_ids[0] for s in segments))
    prog.meta["segment_plan"] = plan
    prog.meta["segments"] = len(plan.segments)
    return plan


def schedule(prog: TriggeredProgram, *, throttle: str = "adaptive",
             resources: int = 64, merged: bool = True,
             ordered: bool = False, nstreams: int = 1,
             node_aware: bool = False,
             coalesce: bool = False,
             pack: bool = False,
             chunk_bytes: int = 0,
             fused: bool = False,
             verify: bool = False) -> TriggeredProgram:
    """Apply all schedule passes; returns the same (mutated) program.

    ``pack`` runs after the ordering pass (P2P chains gate every put, so
    an ordered program packs nothing — aggregation and message-matching
    semantics are mutually exclusive by construction) and BEFORE
    throttling, because the finite triggered-op slots hold descriptors:
    a packed group consumes one. ``chunk_bytes`` runs between them —
    after pack (a packed descriptor chunks over its staging concat,
    composing the two) and before throttle (the slots hold CHUNK
    descriptors; each in-flight chunk occupies one). ``node_aware``
    runs after throttling (it must respect every dependency edge the
    earlier passes placed) and before stream assignment (the
    cross-stream conflict edges are derived from the final emission
    order).

    ``fused=True`` runs :func:`plan_segments` over the finished schedule
    (after every edge is final) and marks the program for the
    device-resident progress engine: :func:`repro_torch.core.engine.run_fused`
    launches one fused emission unit per segment instead of walking the
    DAG op by op, and the simulator charges host dispatch per segment.

    ``verify=True`` additionally runs the static verifier
    (:mod:`repro_torch.core.verify`) over the finished schedule and raises
    :class:`repro_torch.core.verify.ScheduleVerificationError` on any
    error-severity finding (race, unsatisfiable wait, slot overflow,
    malformed descriptor, ...)."""
    prog = fuse_signals(prog, merged)
    prog = ordering_pass(prog, ordered)
    prog = pack_puts(prog, pack)
    prog = chunk_puts(prog, chunk_bytes)
    prog = throttle_pass(prog, throttle, resources)
    prog = node_aware_pass(prog, node_aware, coalesce)
    prog = assign_streams(prog, nstreams)
    prog = validate_deps(prog)
    prog.meta["fused"] = bool(fused)
    if fused:
        plan_segments(prog)
    if verify:
        from repro_torch.core.verify import verify as _verify
        _verify(prog).raise_if_errors()
    return prog
