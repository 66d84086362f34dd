"""Stage 3 — the ST and host-orchestrated executors.

Both walk the SAME :class:`TriggeredProgram` the schedule passes
produced and emit every descriptor through
:func:`repro_torch.core.engine.emit_node`; they differ only in WHEN the
host waits:

  * :func:`run_compiled` (Fig. 9b, mode="st"): every descriptor is
    enqueued eagerly on the current CUDA stream, in a topological order
    of the DAG, with NO host synchronisation until
    ``STStream.synchronize`` ends — the device runs the whole program
    (all iterations) without the CPU in the loop. (Capturing it as one
    CUDA graph is later work.)

  * :func:`run_host` (Fig. 9a, mode="host"): the CPU-orchestrated
    standard active-RMA baseline — one dispatch per descriptor, the host
    blocking on the device at every epoch boundary (start/complete/wait).
    A put's completion signal is its own counter bump after the payload
    put, like the MPI runtime's completion handling; a wire completion
    signal is also its own dispatch. Dependency edges are not
    re-checked while dispatching: the serialized order must satisfy
    them, and :func:`_assert_dispatch_order` proves it does before the
    first dispatch.

Each executor adds its dispatch units, the cost simulator's accounting
unit, to ``stream.dispatches``: one per descriptor (plus one per
separately dispatched wire completion signal in host mode). A unit is
not a device launch: start/complete/wait descriptors launch nothing; in
st and fused mode a put is one launch, its permuted copy with its
completion signal (``put_signal``); in host mode it is two, the copy and
then a counter bump.
"""
from __future__ import annotations

from repro_torch.core.compat import block
from repro_torch.core.engine import _emit_completion_signal, emit_node
from repro_torch.core.schedule import stream_interleaved_order


def run_compiled(stream, prog, state):
    # multi-stream schedules emit in a stream-interleaved topological
    # order (program order within a stream; cross-stream ordering only
    # where a real dependency edge ties it)
    st = dict(state)
    for node in stream_interleaved_order(prog):
        stream.dispatches += 1
        st = emit_node(stream, node, st)
    return st


_BLOCKING = ("start", "complete", "wait")


def _assert_dispatch_order(prog):
    """Prove the serialized dispatch order satisfies every dependency
    edge before dispatching anything.

    run_host never re-emits dep edges — correctness rests entirely on
    ``prog.nodes`` order respecting them. A schedule whose edge points
    FORWARD (a node depending on an op dispatched later — e.g. a
    multi-stream program handed to the host path without re-ordering)
    raises, with a witness cycle from
    :func:`repro_torch.core.verify.find_cycle` over the waiting-for graph
    (each node waits for its unemitted deps AND its dispatch
    predecessor)."""
    pos = {n.op_id: i for i, n in enumerate(prog.nodes)}
    violated = [(n, d) for n in prog.nodes for d in n.deps
                if d in pos and pos[d] > pos[n.op_id]]
    if not violated:
        return
    from repro_torch.core.verify import find_cycle

    nodes = {n.op_id: n for n in prog.nodes}

    def waiting_for(op_id):
        succ = [d for d in nodes[op_id].deps if d in nodes]
        i = pos[op_id]
        if i > 0:
            succ.append(prog.nodes[i - 1].op_id)
        return succ

    cyc = find_cycle(nodes, waiting_for)
    witness = " -> ".join(f"{nodes[i].kind}#{i}" for i in (cyc or []))
    n, d = violated[0]
    raise ValueError(
        f"run_host: dependency edge out of dispatch order — "
        f"{n.kind}#{n.op_id} ({n.label or n.window}) depends on op {d} "
        f"dispatched only later; the serialized host order would "
        f"silently ignore the edge. Re-schedule for the host path "
        f"(nstreams=1) or use the st/fused executors. "
        f"Witness cycle: {witness or 'forward edge'}")


def run_host(stream, prog, state):
    _assert_dispatch_order(prog)
    st = dict(state)
    for node in prog.nodes:
        stream.dispatches += 1
        if node.kind == "put" and node.chained is not None:
            # baseline RMA: the payload put, then the completion signal as
            # its own bump (the MPI runtime's completion handling), a
            # dispatch of its own when it crosses the wire
            st = emit_node(stream, node, st, with_chained=False)
            if node.chained.wire:
                stream.dispatches += 1
            st = _emit_completion_signal(stream, node, st)
        else:
            st = emit_node(stream, node, st)
        if node.kind in _BLOCKING:
            block(stream.device)
    return st
