"""Stage 1 — lowering: STStream op queue -> triggered-op descriptor DAG.

The enqueue API (post/start/put/complete/wait/launch) records opaque
`_Op` entries; this pass lowers one hostsync-delimited segment of that
queue into a :class:`TriggeredProgram` of real :class:`TriggeredOp`
descriptors with named trigger/completion counter slots:

  * post   -> one "post" signal descriptor per neighbor (a tiny triggered
              put bumping the target's ``win.post_sig[opposite(d)]`` slot,
              paper §5.1.2); the merged-signal pass may later fuse them.
  * start  -> a "start" marker snapshotting the post counter; every put
              of the epoch is armed by it (trigger_counter).
  * put    -> a payload put descriptor, DEFERRED to its epoch's complete
              (the ST executor fires enqueued descriptors at the trigger
              event complete() emits). Each put carries its §3.2 chained
              completion signal bumping ``win.comp_sig[opposite(d)]`` on
              the target, plus the GROUP identity the pack_puts schedule
              pass aggregates multi-buffer descriptors by: its full rank
              permutation (``perm``), source dtype, and real byte size —
              so a packed group's single chained signal stands for the
              whole group and the wait's ``expected_puts`` can be
              recounted per descriptor, not per buffer. A MULTICAST put
              (``put_multicast``) lowers to one descriptor carrying
              every branch direction (``mcast_dirs``) and one chained
              completion tree (slots-based, one signal at the source).
  * complete -> emits the epoch's deferred puts, then an epoch-close
              marker; the global epoch index increments here.
  * wait   -> a wait-kernel descriptor polling the completion counter.

Pure structural transformation: no torch imports, no policy decisions —
throttling/ordering/fusion happen in :mod:`repro_torch.core.schedule`. The
lowering is PATTERN-AGNOSTIC: which peers a post signals and which
counter slot a put's completion lands in come from the window's
:class:`~repro_torch.core.patterns.PatternTopology` (Faces negation vs
modular shift groups), never from halo-exchange assumptions here.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.dtypes import dtype_name, dtype_size
from repro_torch.core.triggered import TriggeredOp, TriggeredProgram


def window_buffer_spec(windows, qualified: str):
    """(nbytes, dtype_name) of ``qualified`` resolved against a windows
    dict (``{name: STWindow}``) — the stream-free variant of
    :func:`buffer_spec` for consumers that only hold a scheduled
    program (the segment planner's arena layout); (0, "") when no
    window owns the key (counter names, staging keys). Window specs
    hold numpy dtype names ("float32"), never torch dtypes, so
    :mod:`~repro_torch.core.dtypes` gives the JAX package's names and
    sizes."""
    for win in windows.values():
        prefix = win.name + "."
        if qualified.startswith(prefix):
            spec = win.spec_of(qualified[len(prefix):])
            if spec is not None:
                shape, dtype = spec
                nbytes = int(np.prod(shape)) * dtype_size(dtype)
                return nbytes, dtype_name(dtype)
    return 0, ""


def buffer_spec(stream, qualified: str):
    """(nbytes, dtype_name) of a window buffer like ``"faces.send101"``
    (pong keys resolve to their ping buffer's spec); (0, "") when no
    window owns the key. The dtype is threaded onto put nodes so the
    pack_puts schedule pass only merges byte-compatible payloads into
    one staging buffer."""
    return window_buffer_spec(stream.windows, qualified)


def arena_layout(windows, buffer_names, *, align: int = 64):
    """Static per-segment device arena: assign every buffer/counter name
    in ``buffer_names`` a fixed, ``align``-aligned byte offset, returning
    ``(offsets, arena_nbytes)``.

    Window buffers reserve their real payload size (rounded up to the
    alignment); names no window owns — counter slots, pack/chunk staging
    keys — reserve one aligned slot each (a counter is a single int32
    cell; the alignment quantum keeps concurrent bumps on separate cache
    lines). Offsets are assigned in sorted-name order, so the layout is
    a pure function of the footprint: the engine can bake the offsets
    into its fused emission unit and the host never recomputes them."""
    offsets: Dict[str, int] = {}
    off = 0
    for name in sorted(buffer_names):
        nbytes, _ = window_buffer_spec(windows, name)
        slot = -(-max(int(nbytes), align) // align) * align
        offsets[name] = off
        off += slot
    return offsets, off


def put_link(stream, win, direction):
    """(link, node_deltas, perm) of a put in ``direction`` on ``win``:
    the window topology's node mapping (``ranks_per_node``) classifies
    the put as on-node ("intra", xGMI) or off-node ("inter", through the
    NIC) over the direction's full rank permutation — which is also
    returned (as a hashable tuple): two puts with EQUAL permutations
    move their payloads between identical rank pairs, the exact identity
    the pack_puts pass groups multi-buffer descriptors by. Windows
    without a topology (or without a node mapping) are single-node:
    "intra"."""
    perm = tuple(map(tuple, stream.perm_for(tuple(direction))))
    topo = getattr(win, "topology", None)
    if topo is None or not getattr(topo, "ranks_per_node", None):
        return "intra", (), perm
    link, deltas = topo.link_of(list(perm))
    return link, deltas, perm


def lower_segment(stream, seg) -> TriggeredProgram:
    """Lower one segment of the deferred-op queue onto the IR.

    Epoch indices are global across the segment; each op additionally
    carries its ``phase`` (ping/pong parity chosen by the pattern) so
    double-buffered windows resolve counter slots and data buffers to the
    right parity's set. A put's trigger threshold counts the epochs
    closed on ITS parity's counter (== epoch+1 for single-buffered
    windows)."""
    nodes: List[TriggeredOp] = []
    pending: Dict[str, List[TriggeredOp]] = {}   # window -> epoch's puts
    epoch = 0
    closed: Dict[str, int] = {}          # window -> last closed epoch
    nclosed: Dict[tuple, int] = {}       # (window, phase) -> epochs closed
    last_dsts: Dict[str, tuple] = {}     # window -> last epoch's put dsts
    put_counts: Dict[tuple, int] = {}    # (window, epoch) -> puts flushed

    for op in seg:
        if op.kind == "kernel":
            nodes.append(TriggeredOp(
                "kernel", fn=op.fn, fn_token=op.fn_token, reads=op.reads,
                writes=op.writes, label=op.label))
        elif op.kind == "post":
            win = op.window
            for d in win.group:
                nodes.append(TriggeredOp(
                    "signal", window=win.name, role="post",
                    direction=tuple(d),
                    slot=win.opposite_index(d),
                    counter=win.post_sig_at(op.phase), wire=True,
                    epoch=epoch, phase=op.phase,
                    label=f"post{tuple(d)}"))
        elif op.kind == "start":
            win = op.window
            nodes.append(TriggeredOp(
                "start", window=win.name,
                counter=win.post_sig_at(op.phase),
                epoch=epoch, phase=op.phase, label=op.label))
        elif op.kind == "put" and "directions" in op.put:
            # multicast put (STStream.put_multicast): ONE src payload
            # fans out to every branch direction's rank — one descriptor,
            # one NIC injection (the switch replicates), and ONE chained
            # completion tree whose leaves bump each branch target's
            # comp slot (counted as one signal at the source). Lands on
            # "inter" when ANY branch crosses a node boundary. perm stays
            # empty: a one-to-many descriptor never joins a pack group.
            win = op.window
            dirs = tuple(tuple(d) for d in op.put["directions"])
            slots = tuple((win.opposite_index(d), d) for d in dirs)
            link = "intra"
            for d in dirs:
                branch_link, _, _ = put_link(stream, win, d)
                if branch_link == "inter":
                    link = "inter"
            chained = TriggeredOp(
                "signal", window=win.name, role="completion",
                direction=dirs[0], slots=slots, fused=True,
                counter=win.comp_sig_at(op.phase), wire=True,
                phase=op.phase, label=f"comp_mcast[{len(dirs)}]")
            nbytes, dtype = buffer_spec(stream, op.put["src"])
            pending.setdefault(win.name, []).append(TriggeredOp(
                "put", window=win.name, src=op.put["src"],
                dsts=tuple(op.put["dsts"]), direction=dirs[0],
                mcast_dirs=dirs, nbytes=nbytes, dtype=dtype, link=link,
                trigger_counter=(f"{win.post_sig_at(op.phase)}"
                                 f"[{win.group.index(dirs[0])}]"),
                completion_counter=win.comp_sig_at(op.phase),
                chained=chained, phase=op.phase,
                label=f"mput[{len(dirs)}]"))
        elif op.kind == "put":
            win = op.window
            d = tuple(op.put["direction"])
            slot = win.opposite_index(d)
            chained = TriggeredOp(
                "signal", window=win.name, role="completion",
                direction=d, slot=slot,
                counter=win.comp_sig_at(op.phase), wire=True,
                phase=op.phase, label=f"comp{d}")
            link, deltas, perm = put_link(stream, win, d)
            nbytes, dtype = buffer_spec(stream, op.put["src"])
            pending.setdefault(win.name, []).append(TriggeredOp(
                "put", window=win.name, src=op.put["src"],
                dst=op.put["dst"], direction=d,
                nbytes=nbytes, dtype=dtype, perm=perm,
                link=link, node_deltas=deltas,
                trigger_counter=(f"{win.post_sig_at(op.phase)}"
                                 f"[{win.group.index(d)}]"),
                completion_counter=f"{win.comp_sig_at(op.phase)}[{slot}]",
                chained=chained, phase=op.phase, label=f"put{d}"))
        elif op.kind == "complete":
            win = op.window
            arm = nclosed.get((win.name, op.phase % 2), 0)
            flushed = pending.pop(win.name, [])
            for p in flushed:
                p.epoch = epoch
                p.threshold = arm + 1
                if p.chained is not None:
                    p.chained.epoch = epoch
                nodes.append(p)
            nodes.append(TriggeredOp(
                "complete", window=win.name, epoch=epoch, phase=op.phase))
            closed[win.name] = epoch
            nclosed[(win.name, op.phase % 2)] = arm + 1
            # a multicast put delivers into its per-branch dsts (dst is
            # None); the wait fence must cover every landing buffer
            last_dsts[win.name] = tuple(
                d for p in flushed
                for d in (p.dsts if p.dsts else (p.dst,)) if d)
            put_counts[(win.name, epoch)] = len(flushed)
            epoch += 1
        elif op.kind == "wait":
            win = op.window
            w_epoch = closed.get(win.name, 0)
            # the fence covers exactly what the epoch's puts delivered:
            # readers of the received buffers must follow the wait, but
            # compute state (src/accumulators) stays free to overlap on
            # the compute stream. expected_puts threads the epoch's put
            # count to the simulator: a wait whose epoch recorded a
            # different number of completions is a schedule bug, not a
            # resolve-at-t0 (zero puts stays legitimate for peer-less
            # epochs, e.g. a single-shard a2a).
            nodes.append(TriggeredOp(
                "wait", window=win.name,
                counter=win.comp_sig_at(op.phase),
                epoch=w_epoch, phase=op.phase,
                expected_puts=put_counts.get((win.name, w_epoch), 0),
                writes=last_dsts.get(win.name, ())))
        else:
            raise ValueError(f"cannot lower op kind {op.kind!r}")

    if pending:
        # a put's descriptor only fires at its epoch's complete(); an
        # unclosed access epoch at a host_sync/end-of-program would be
        # silent data loss, so refuse to lower it
        raise ValueError(
            "puts enqueued without a closing complete() for window(s) "
            f"{sorted(pending)} — close the access epoch before "
            "host_sync() or synchronize()")

    return TriggeredProgram(
        nodes=nodes, windows=dict(stream.windows),
        meta={"pattern": getattr(stream, "pattern", ""),
              "double_buffer": any(w.double_buffer
                                   for w in stream.windows.values())})


def split_segments(program) -> List[list]:
    """Split the raw op queue at host_sync() points (paper §5.2.1
    application-level throttling: each segment is its own device program
    with a full host block between them)."""
    segs, cur = [], []
    for op in program:
        if op.kind == "hostsync":
            if cur:
                segs.append(cur)
            cur = []
        else:
            cur.append(op)
    if cur:
        segs.append(cur)
    return segs
