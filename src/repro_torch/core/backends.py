"""Stage 3 — the ST and host-orchestrated executors.

Both walk the SAME :class:`TriggeredProgram` the schedule passes
produced and emit every descriptor through
:func:`repro_torch.core.engine.emit_node`; they differ only in WHEN the
host waits:

  * :func:`run_compiled` (Fig. 9b, mode="st"): the whole program (all
    iterations) is ONE CUDA graph, captured at its first run and cached
    on the stream as ``_compiled_cache`` (the JAX package's jitted
    executable and its cache), keyed by ``prog.key()`` and each state
    key's shape, dtype and stride. The capture emits every descriptor in
    ``stream_interleaved_order``, a topological order of the DAG; a run
    is one graph launch with NO host synchronisation until
    ``STStream.synchronize`` ends — the device runs the program without
    the CPU in the loop. On the CPU the same emission runs eagerly
    (:func:`_emit_st`).

  * :func:`run_host` (Fig. 9a, mode="host"): the CPU-orchestrated
    standard active-RMA baseline — one dispatch per descriptor, the host
    blocking on the device at every epoch boundary (start/complete/wait).
    It stays eager on the card too: the host in the loop is what it
    measures (the JAX package dispatches one jitted executable per
    descriptor there). A put's completion signal is its own counter bump
    after the payload put, like the MPI runtime's completion handling; a
    wire completion signal is also its own dispatch. Dependency edges are
    not re-checked while dispatching: the serialized order must satisfy
    them, and :func:`_assert_dispatch_order` proves it does before the
    first dispatch.

Each executor adds its dispatch units, the cost simulator's accounting
unit, to ``stream.dispatches``: one per descriptor (plus one per
separately dispatched wire completion signal in host mode). A unit is
not a device launch: start/complete/wait descriptors launch nothing; in
st and fused mode a put is one kernel, its permuted copy with its
completion signal (``put_signal``), inside the program's graph; in host
mode it is two launches, the copy and then a counter bump.
"""
from __future__ import annotations

import weakref

from repro_torch.core import graphs
from repro_torch.core.compat import block
from repro_torch.core.engine import (_emit_completion_signal, emit_node,
                                     program_graph)
from repro_torch.core.schedule import stream_interleaved_order
from repro_torch.core.spans import span


def _emit_st(stream, prog, state):
    """The ST program emitted eagerly, descriptor by descriptor, in
    ``stream_interleaved_order`` (multi-stream schedules: program order
    within a stream, cross-stream ordering only where a dependency edge
    ties it). What :func:`run_compiled` captures; the CPU route, and the
    yardstick the graph is held to on the card."""
    st = dict(state)
    for node in stream_interleaved_order(prog):
        st = emit_node(stream, node, st)
    return st


def run_compiled(stream, prog, state):
    stream.dispatches += len(prog.nodes)
    if not graphs.applies(stream.device):
        return _emit_st(stream, prog, state)
    # the graph, held by the stream, holds the stream weakly
    ref = weakref.proxy(stream)
    with span("repro_torch.st.lookup"):
        g = program_graph(
            stream, stream._compiled_cache, prog, state,
            f"the ST program ({len(prog.nodes)} descriptors)",
            lambda: [lambda st: _emit_st(ref, prog, st)])
    return g(state)


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
