"""Cost model + event-driven simulator over the scheduled descriptor DAG.

This is the fourth stage-3 consumer: it walks the SAME
:class:`TriggeredProgram` the executors in :mod:`repro_torch.core.backends`
and the fused engine in :mod:`repro_torch.core.engine` emit, so the
benchmarks' "derived" column is computed from the identical schedule
the device runs — throttling, ordering, and signal-fusion decisions all
arrive as structure (dependency edges, fused nodes), never as policy
branches re-implemented here.

FUSED schedules (``schedule(..., fused=True)`` — the device-resident
progress engine) charge host dispatch PER SEGMENT, not per descriptor:
the host's only job is launching each planned segment's fused emission
unit; the device-resident counters sequence everything inside it. The
``t_dispatch`` charge therefore lands only on segment-head descriptors
(``SegmentPlan.heads``) — :func:`host_dispatch_count` exposes the
resulting count so benchmarks can show per-segment dispatches strictly
below the per-op count of the unfused schedule.

One card holding every rank cannot reproduce Slingshot/MI250 link
latencies, so measured times are complemented with this simulation (an
exact copy of the JAX package's, so both price identical schedules).
Cost parameters (defaults loosely follow the paper's system: host
dispatch and kernel-launch costs dominate small-message halo exchange):

  t_dispatch — host enqueue of one descriptor (CPU -> queue)   [us]
  t_launch   — device kernel launch/teardown                   [us]
  t_sync     — host<->device synchronization (hipStreamSync)   [us]
  t_put(l,b) — per-LINK alpha-beta put latency for b bytes     [us]
  t_signal   — tiny signal put                                 [us]

The put cost is a per-link alpha-beta model: an "intra" put rides the
on-node xGMI fabric (alpha = ``put_base``, beta = ``put_per_kb``); an
"inter" put crosses the Slingshot NIC (``inter_base``/``inter_per_kb``,
strictly costlier at every size — the paper's open off-node gap).
Inter-node puts additionally SERIALIZE their injection on the rank's
single NIC (``t_nic`` timeline): the NIC is busy for the put's beta
term, so a burst of off-node puts drains one after another — the lever
``schedule.node_aware_pass`` exploits by issuing them first. Every real
wire message pays its per-message alpha; the former simulator-only
waiver for ``aggregated``-marked puts is gone — materialized packing
(``schedule.pack_puts``) is the aggregation both executors can realize,
so the marking is an ordering/bookkeeping hint with no cost effect.

A CHUNKED put (``schedule.chunk_puts`` split a large payload into a
pipelined chain) prices each chunk's beta on the NIC timeline, but only
the FIRST chunk (``chunk_index == 0``) pays the per-message alpha: the
tail chunks stream down the already-open wire path behind it, so the
whole message completes at ``max(alpha + beta*chunk, beta*total)``-ish
instead of ``alpha + beta*total`` — strictly earlier once the NIC is
the bottleneck. Each chunk still pays its own ``t_issue`` dequeue.

A MULTICAST put (one src payload, ``mcast_dirs`` branch fanout) prices
as exactly ONE message — one injection of the payload's beta, one
alpha, one chained completion (the switch replicates; the completion
tree counts as one signal at the source) — versus one full message per
branch for the equivalent unicast fanout.

A PACKED multi-buffer descriptor (``schedule.pack_puts`` materialized a
whole aggregation group into one node) is priced as exactly one
descriptor: one host dispatch, one ``t_issue`` dequeue on the issuing
stream, one per-message alpha, the SUMMED beta of its payloads (one
contiguous staging buffer on the wire), one NIC injection slot, and one
chained completion — versus N of each for the unpacked group. For
off-node groups the packed cost is therefore <= the unpacked cost at
every size (N-1 saved alphas, issues, and dispatches; the betas sum
either way because the NIC serializes injections).

Timeline model: the host enqueues every descriptor (t_dispatch each);
each device STREAM executes its kernels/signals/waits in program order
on its own timeline (``t_dev[stream]`` — single-stream programs have
exactly one); puts are offloaded (the issuing stream continues while the
NIC moves bytes) and start no earlier than the completion of every
dependency edge the schedule passes added; a wait kernel polls until its
epoch's put completions have landed — and RAISES when the number of
recorded completions differs from the put count lowering threaded into
the node (``expected_puts``): a wait silently resolving at t=0 was the
same bug class as a dangling edge. Zero expected puts (peer-less epoch,
e.g. single-shard a2a) stays a legitimate immediate resolve.
Cross-stream ordering flows ONLY through dependency edges resolved in
``done`` — an edge naming an op_id outside the program raises instead
of being treated as completed at t=0 (dangling edges used to silently
vanish here).
``host_orchestrated=True`` models the Fig. 9a baseline: the device waits
for each dispatch and every epoch boundary (start/complete/wait) pays a
full host round-trip.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.core.triggered import TriggeredProgram


@dataclass
class CostModel:
    t_dispatch: float = 0.3
    t_launch: float = 4.0
    t_sync: float = 12.0
    t_signal: float = 1.2
    t_issue: float = 0.2        # stream dequeues one put descriptor [us]
    put_base: float = 2.0       # intra-node (xGMI) alpha          [us]
    put_per_kb: float = 0.05    # intra-node beta                  [us/KB]
    inter_base: float = 9.0     # inter-node (Slingshot) alpha     [us]
    inter_per_kb: float = 0.35  # inter-node beta = NIC injection  [us/KB]

    def link_cost(self, link: str):
        """(alpha, beta) of a link class; unknown classes price as the
        off-node link (the conservative choice)."""
        if link == "intra":
            return self.put_base, self.put_per_kb
        return self.inter_base, self.inter_per_kb

    def t_put(self, link, nbytes: Optional[int] = None) -> float:
        """Alpha-beta put latency. ``t_put("inter", b)`` prices a link;
        the pre-topology single-argument form ``t_put(b)`` still works
        and prices the intra-node link."""
        if nbytes is None:
            link, nbytes = "intra", link
        alpha, beta = self.link_cost(link)
        return alpha + beta * nbytes / 1024.0


def _segment_heads(prog: TriggeredProgram):
    """``SegmentPlan.heads`` of a fused program (planning lazily if the
    schedule skipped it), or ``None`` for unfused schedules — the
    simulator charges ``t_dispatch`` only on these op_ids when fused."""
    if not prog.meta.get("fused"):
        return None
    plan = prog.meta.get("segment_plan")
    if plan is None:
        from repro_torch.core.schedule import plan_segments
        plan = plan_segments(prog)
    return plan.heads


def host_dispatch_count(prog: TriggeredProgram) -> int:
    """Number of host dispatches the cost model charges for one program:
    one per descriptor normally, one per SEGMENT for fused schedules
    (the progress-engine win the benchmarks report — strictly below the
    per-op count whenever a segment holds more than one descriptor)."""
    heads = _segment_heads(prog)
    if heads is None:
        return len(prog.nodes)
    return len(heads)


def simulate_program(prog: TriggeredProgram, cm: Optional[CostModel] = None,
                     host_orchestrated: bool = False) -> float:
    """Critical-path completion time (us) of one scheduled program."""
    cm = cm or CostModel()
    merged = bool(prog.meta.get("merged", True))
    heads = _segment_heads(prog)
    known = {n.op_id for n in prog.nodes}
    t_host = 0.0                        # host (dispatch) timeline
    t_dev: Dict[int, float] = defaultdict(float)   # per-stream timelines
    t_nic = 0.0                         # the rank's NIC injection timeline:
    #                                     inter-node puts serialize here
    done: Dict[int, float] = {}         # op_id -> completion time
    comp_at: Dict[tuple, List[float]] = defaultdict(list)
    #                                   (window, epoch) -> put completions

    def block(*extra):
        nonlocal t_host
        t = max([t_host] + list(t_dev.values()) + list(extra)) + cm.t_sync
        t_host = t
        for s in list(t_dev):
            t_dev[s] = t

    def resolve(node, start):
        for dep in node.deps:
            if dep not in known:
                raise ValueError(
                    f"simulate_program: dependency edge {dep} of "
                    f"{node.kind}/{node.label or node.op_id} names an op "
                    "outside this program (dangling edge)")
            start = max(start, done[dep])
        return start

    for node in prog.nodes:
        s = node.stream
        if heads is None or node.op_id in heads:
            # fused progress engine: the host dispatches once per planned
            # SEGMENT (its head descriptor); device-resident counters
            # sequence the rest of the segment with zero host involvement
            t_host += cm.t_dispatch
        start = t_dev[s]
        if host_orchestrated:
            start = max(start, t_host)
        start = resolve(node, start)
        if node.kind == "kernel":
            t_dev[s] = start + cm.t_launch
        elif node.kind == "signal":
            # post signals: one fused launch vs a launch per neighbor
            t_dev[s] = start + (cm.t_signal if node.fused
                                else cm.t_launch + cm.t_signal)
        elif node.kind == "put":
            if node.srcs and len(node.srcs) != len(node.dsts):
                raise ValueError(
                    f"simulate_program: packed put "
                    f"{node.label or node.op_id} carries {len(node.srcs)} "
                    f"source(s) but {len(node.dsts)} destination(s) — a "
                    "packed descriptor's buffer lists must pair up")
            alpha, beta = cm.link_cost(node.link or "intra")
            xfer = beta * node.nbytes / 1024.0
            # a tail chunk of a pipelined chain (chunk_puts) streams
            # behind its head down the already-open wire path: it pays
            # its own beta (and NIC injection) but no per-message alpha
            tail_chunk = node.chunk_index > 0
            if node.link == "inter":
                # the rank's single NIC injects off-node puts one after
                # another: busy for the bandwidth (beta) term, then the
                # wire alpha until the payload lands. A multicast put
                # injects its payload ONCE (the switch replicates the
                # branches), so it prices identically to one unicast.
                inject = max(start, t_nic)
                t_nic = inject + xfer
                end = t_nic + (0.0 if tail_chunk else alpha)
            else:
                end = start + xfer + (0.0 if tail_chunk else alpha)
            comp = end
            # offloaded: the issuing stream continues after dequeuing
            # the descriptor (t_issue) — issue ORDER therefore matters,
            # which is what node_aware_pass optimizes (off-node puts
            # reach the NIC in the earliest issue slots)
            t_dev[s] = start + cm.t_issue
            if node.chained is not None and node.chained.wire:
                # §3.2 chained wire signal: its own tiny launch on the
                # issuing stream plus a wire hop before completion lands
                if host_orchestrated:
                    t_host += cm.t_dispatch      # separate dispatch
                t_dev[s] += cm.t_launch + cm.t_signal
                comp = end + cm.t_signal
            done[node.op_id] = comp
            comp_at[(node.window, node.epoch)].append(comp)
            continue
        elif node.kind == "start":
            t_dev[s] = start
            if host_orchestrated:
                block()
        elif node.kind == "complete":
            # merged completion-signal kernel for the epoch
            t_dev[s] = start + (cm.t_signal if merged else 0.0)
            if host_orchestrated:
                block(max(done.values(), default=0.0))
        elif node.kind == "wait":
            # the wait kernel polls the completion counter until its
            # epoch's puts have landed — THE serialization point the
            # multi-stream schedule confines to the communication stream
            comps = comp_at.get((node.window, node.epoch), [])
            if node.expected_puts >= 0 and len(comps) != node.expected_puts:
                raise ValueError(
                    f"simulate_program: wait on ({node.window!r}, epoch "
                    f"{node.epoch}) recorded {len(comps)} put "
                    f"completion(s) but lowering expected "
                    f"{node.expected_puts} — a wait must not silently "
                    "resolve at t=0 (same class as a dangling edge); "
                    "zero-put epochs are legitimate only when lowering "
                    "flushed zero puts")
            arrived = max(comps, default=0.0)
            t_dev[s] = max(start, arrived) + cm.t_launch
            if host_orchestrated:
                block()
        done[node.op_id] = t_dev[s]
    return max([t_host] + list(t_dev.values())
               + list(done.values() or [0.0]))


def simulate_pipeline(progs: Sequence[TriggeredProgram],
                      cm: Optional[CostModel] = None,
                      host_orchestrated: bool = False) -> float:
    """Total time of a host_sync-split program pipeline: each segment is
    its own device program followed by a full host block (the final
    synchronize() block included — matching STStream.synchronize)."""
    cm = cm or CostModel()
    return sum(simulate_program(p, cm, host_orchestrated) + cm.t_sync
               for p in progs)


# ---------------------------------------------------------------------------
# convenience: device-free Faces wrappers kept for existing callers —
# the generic versions (any pattern) are patterns.pattern_programs /
# patterns.simulate_pattern
# ---------------------------------------------------------------------------

def faces_programs(niter: int, n=(8, 8, 8), grid=(2, 2, 2), *,
                   throttle: str = "adaptive", resources: int = 16,
                   merged: bool = True, ordered: bool = False,
                   host_sync_every: int = 0) -> List[TriggeredProgram]:
    """Lower+schedule a Faces program on a device-free stream — the same
    constructor and passes the executors use, minus a device. With
    ``host_sync_every=k`` the program splits every k iterations
    (application-level throttling, §5.2.1)."""
    from repro_torch.core.patterns import pattern_programs

    return pattern_programs("faces", niter, grid=grid, n=n,
                            throttle=throttle, resources=resources,
                            merged=merged, ordered=ordered,
                            host_sync_every=host_sync_every)


def simulate_faces(niter: int, n=(8, 8, 8), *, policy: str = "adaptive",
                   resources: int = 16, merged: bool = True,
                   ordered: bool = False, host_orchestrated: bool = False,
                   cm: Optional[CostModel] = None) -> float:
    """Derived critical-path time of the Faces inner loop under a policy
    (see :func:`repro_torch.core.patterns.simulate_pattern` for the
    application-split semantics and the Fig. 13 ordering argument)."""
    from repro_torch.core.patterns import simulate_pattern

    return simulate_pattern("faces", niter, n=n, policy=policy,
                            resources=resources, merged=merged,
                            ordered=ordered,
                            host_orchestrated=host_orchestrated, cm=cm)
