"""Static schedule verifier — prove properties of a scheduled program
WITHOUT executing it.

The stream-triggered strategy defers all synchronization into
device-side counter thresholds and chained completion signals, which
means a mis-scheduled program does not crash: it silently races or
hangs on-device. The simulator catches SOME of that at "runtime"
(wait-count mismatches, dangling edges), but only along the one
interleaving it walks. This pass suite analyzes the scheduled
:class:`~repro_torch.core.triggered.TriggeredProgram` itself and proves four
property families over EVERY execution the schedule admits:

1. **Happens-before race detection** (``"race"``). Every op maps to
   one or two EVENTS: puts are offloaded, so a put occupies its stream
   only at its *issue* event while its payload lands at a separate
   *completion* event; every other op is a single event. The HB
   relation is the transitive closure of

     * per-stream program order (chaining the stream-occupancy events:
       a put blocks its stream only at issue),
     * issue(put) -> completion(put),
     * dependency edges (depending on a put means "payload delivered":
       the edge leaves the put's completion event),
     * counter joins: a put's chained completion signal releases every
       wait polling the same (window, epoch, counter), so
       completion(put) -> wait,
     * segment boundaries (fused schedules only): the device-resident
       progress engine launches wave w+1's fused emission units only
       after every wave-w segment retired, so each wave-w op's terminal
       event happens-before every wave-(w+1) segment head.

   A put reads its payload from issue until completion (the NIC streams
   the bytes), so source reads are attributed to BOTH events; dst
   writes and the chained bump land at completion; a wait fences
   (reads+writes) the buffers its epoch's puts delivered. Two accesses
   to one window buffer with a RAW/WAR/WAW conflict and no HB ordering
   in either direction are a race. Counter slots are excluded by
   design: counter traffic is ATOMIC increments and polls (bump order
   is immaterial), so a misdirected bump is a *liveness* defect (the
   wait starves), never a data race. Chunk descriptors of ONE chain
   touch disjoint element ranges of their logical payload and never
   race each other; range overlap inside a chain is a lint finding
   instead. This pass independently re-derives what
   ``schedule.assign_streams``' cross-stream conflict edges are
   supposed to guarantee — it trusts the edges' EFFECT, not their
   construction.

2. **Deadlock / liveness analysis** (``"unsatisfiable-wait"``,
   ``"phantom-completion"``, ``"unsatisfiable-trigger"``,
   ``"deadlock-cycle"``). Counter-threshold semantics are modeled by
   counting: a wait expecting N completions must have exactly N puts
   whose chained signal bumps ITS counter on its epoch (fewer = the
   wait spins forever; more = a phantom completion releases it early —
   both are how a ping/pong parity swap or a truncated chunk chain
   hangs the device). A put's trigger threshold must be reachable from
   the program's post-signal bumps to its (counter, slot) — by SPMD
   symmetry the local program's bumps stand for the neighbor's arriving
   signals. A cycle anywhere in the event graph (dependency edges +
   stream order + counter joins — e.g. a throttle edge pointing forward
   on a stream) can never make progress and is reported with a witness
   cycle.

3. **Descriptor well-formedness lint** (``"bad-perm"``, ``"bad-pack"``,
   ``"bad-chunk"``, ``"bad-mcast"``, ``"bad-slot"``). Per-put rank
   permutations must be bijections on the topology's rank grid; packed
   ``srcs``/``dsts`` must pair up, be distinct, and carry a dtype (the
   staging concat is a pure byte reshuffle); a chunk chain must tile
   its logical payload exactly — indices 0..count-1, offsets
   contiguous, no gaps or overlap; multicast branch sets must pair
   their landing buffers and completion-tree slots with topology
   directions; every signal slot must exist on the window's counter
   buffers.

4. **Resource-safety proof** (``"slot-overflow"``). Replay the puts in
   emission order against the HB relation: a slot is provably free at
   put p's issue only for puts q with completion(q) -> issue(p). The
   maximum in-flight count over the replay upper-bounds every real
   execution (any set of puts simultaneously in flight is a clique of
   the can-overlap relation and is counted intact at its last member),
   so a bound above the throttle policy's ``resources`` means the
   schedule can wedge the NIC's finite descriptor slots.

``verify()`` returns a :class:`VerifyReport`; ``schedule(...,
verify=True)`` runs it after the passes and raises
:class:`ScheduleVerificationError` on errors. The module is torch-free
(the CLI imports pattern builders lazily):

    python -m repro_torch.core.verify                 # all patterns x quick space
    python -m repro_torch.core.verify --pattern ring --nstreams 2
    python -m repro_torch.core.verify --mutations     # seeded-defect corpus

The seeded-defect mutation corpus lives in :mod:`repro_torch.core.defects`;
every mutation class must be caught with the right finding kind while
all four patterns x the autotune quick search space verify clean —
that pairing is what makes the suite trustworthy in both directions.
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import (Callable, Dict, Hashable, Iterable, List, Optional,
                    Sequence, Tuple, TypeVar)

from repro_torch.core.triggered import TriggeredOp, TriggeredProgram

# finding kinds, grouped by pass family (stable strings: tests and the
# mutation corpus match on them)
RACE_KINDS = ("race",)
LIVENESS_KINDS = ("unsatisfiable-wait", "phantom-completion",
                  "unsatisfiable-trigger", "deadlock-cycle")
LINT_KINDS = ("bad-deps", "bad-perm", "bad-pack", "bad-chunk",
              "bad-mcast", "bad-slot")
RESOURCE_KINDS = ("slot-overflow",)
ALL_KINDS = RACE_KINDS + LIVENESS_KINDS + LINT_KINDS + RESOURCE_KINDS

# mirrors repro_torch.core.window.is_counter_name / PONG without importing the
# window module (it pulls in torch; this module stays device-free)
_PONG = "__pp"


def _is_counter(key: str) -> bool:
    return key.endswith("_sig") or key.endswith("_sig" + _PONG)


def _label(n: TriggeredOp) -> str:
    return f"{n.kind}:{n.label or n.op_id}@e{n.epoch}s{n.stream}"


@dataclass(frozen=True)
class Finding:
    """One verified defect: what kind, where, and a minimal witness."""
    kind: str
    severity: str                 # "error" | "warning"
    message: str
    op_ids: Tuple[int, ...] = ()
    witness: Tuple[str, ...] = ()

    def __str__(self) -> str:
        w = f"  [{' -> '.join(self.witness)}]" if self.witness else ""
        return f"{self.severity}:{self.kind}: {self.message}{w}"


@dataclass
class VerifyReport:
    """Findings of one (or several merged) verifier runs."""
    findings: List[Finding] = field(default_factory=list)
    checked: Dict[str, int] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not any(f.severity == "error" for f in self.findings)

    def by_kind(self) -> Dict[str, List[Finding]]:
        out: Dict[str, List[Finding]] = {}
        for f in self.findings:
            out.setdefault(f.kind, []).append(f)
        return out

    def kinds(self) -> Tuple[str, ...]:
        return tuple(sorted({f.kind for f in self.findings}))

    def merge(self, other: "VerifyReport") -> "VerifyReport":
        self.findings.extend(other.findings)
        for k, v in other.checked.items():
            self.checked[k] = self.checked.get(k, 0) + v
        return self

    def summary(self) -> str:
        if not self.findings:
            pairs = self.checked.get("conflict_pairs", 0)
            return (f"clean: {self.checked.get('nodes', 0)} ops, "
                    f"{self.checked.get('events', 0)} events, "
                    f"{pairs} conflict pairs ordered")
        counts = {k: len(v) for k, v in self.by_kind().items()}
        head = ", ".join(f"{k} x{c}" for k, c in sorted(counts.items()))
        lines = [f"{len(self.findings)} finding(s): {head}"]
        lines += [f"  {f}" for f in self.findings[:20]]
        if len(self.findings) > 20:
            lines.append(f"  ... {len(self.findings) - 20} more")
        return "\n".join(lines)

    def raise_if_errors(self):
        if not self.ok:
            raise ScheduleVerificationError(self)
        return self


class ScheduleVerificationError(ValueError):
    """A scheduled program failed static verification."""

    def __init__(self, report: VerifyReport):
        self.report = report
        super().__init__(f"schedule verification failed — "
                         f"{report.summary()}")


# ---------------------------------------------------------------------------
# generic cycle finder (shared with schedule.stream_interleaved_order)
# ---------------------------------------------------------------------------

_Node = TypeVar("_Node", bound=Hashable)


def find_cycle(nodes: Iterable[_Node],
               succ: Callable[[_Node], Iterable[_Node]]
               ) -> Optional[List[_Node]]:
    """First cycle of the directed graph ``(nodes, succ)`` as a node
    list (closed: witness[0] is where the cycle re-enters), or None when
    acyclic. Iterative DFS — programs can be thousands of ops deep."""
    color: Dict[_Node, int] = {}             # 1 = on stack, 2 = done
    for root in nodes:
        if color.get(root):
            continue
        path: List[_Node] = []
        stack: List[tuple] = [(root, iter(tuple(succ(root))))]
        color[root] = 1
        path.append(root)
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                c = color.get(nxt)
                if c == 1:                    # back edge: cycle
                    return path[path.index(nxt):] + [nxt]
                if c is None:
                    color[nxt] = 1
                    path.append(nxt)
                    stack.append((nxt, iter(tuple(succ(nxt)))))
                    advanced = True
                    break
            if not advanced:
                color[node] = 2
                path.pop()
                stack.pop()
    return None


# ---------------------------------------------------------------------------
# event graph: the happens-before model
# ---------------------------------------------------------------------------

class _EventGraph:
    """Per-op events + HB edges of one scheduled program.

    Puts split into an *issue* event (occupies the stream, starts the
    payload read) and a *completion* event (payload delivered: dst
    write, chained bump); everything else is one event. ``issue`` and
    ``done`` map op_id -> event id (equal for non-puts)."""

    def __init__(self, prog: TriggeredProgram):
        self.prog = prog
        self.issue: Dict[int, int] = {}
        self.done: Dict[int, int] = {}
        self.ev_node: List[TriggeredOp] = []
        for n in prog.nodes:
            self.issue[n.op_id] = len(self.ev_node)
            self.ev_node.append(n)
            if n.kind == "put":
                self.done[n.op_id] = len(self.ev_node)
                self.ev_node.append(n)
            else:
                self.done[n.op_id] = self.issue[n.op_id]
        self.nevents = len(self.ev_node)
        succ: List[List[int]] = [[] for _ in range(self.nevents)]
        # issue -> completion
        for n in prog.nodes:
            if n.kind == "put":
                succ[self.issue[n.op_id]].append(self.done[n.op_id])
        # per-stream program order over the stream-occupancy events
        last: Dict[int, int] = {}
        for n in prog.nodes:
            e = self.issue[n.op_id]
            if n.stream in last:
                succ[last[n.stream]].append(e)
            last[n.stream] = e
        # dependency edges: completion-of-dep -> occupancy of the
        # depending op (matches the simulator resolving deps at done[])
        for n in prog.nodes:
            for d in n.deps:
                if d in self.done:
                    succ[self.done[d]].append(self.issue[n.op_id])
        # counter joins: a chained completion signal releases every
        # wait polling the same (window, epoch, counter)
        waits = defaultdict(list)
        for n in prog.nodes:
            if n.kind == "wait":
                waits[(n.window, n.epoch, n.counter)].append(n)
        for p in prog.nodes:
            if p.kind != "put" or p.chained is None:
                continue
            for w in waits.get((p.window, p.epoch, p.chained.counter), ()):
                succ[self.done[p.op_id]].append(self.issue[w.op_id])
        # segment-boundary edges (fused progress engine only): the
        # engine sequences wave w+1's fused emission units behind every
        # wave-w segment's retirement, so the TERMINAL event of each
        # wave-w op (completion for puts, the single event otherwise)
        # happens-before the head event of every wave-(w+1) segment —
        # ordering the planner's wave structure guarantees on top of
        # the explicit dependency edges. All edges point forward in
        # wave order, so they can never introduce a cycle.
        if prog.meta.get("fused"):
            plan = prog.meta.get("segment_plan")
            if plan is None:
                from repro_torch.core.schedule import plan_segments
                plan = plan_segments(prog)
            heads_of_wave: Dict[int, List[int]] = defaultdict(list)
            for seg in plan.segments:
                if seg.op_ids and seg.op_ids[0] in self.issue:
                    heads_of_wave[seg.wave].append(
                        self.issue[seg.op_ids[0]])
            for n in prog.nodes:
                w = plan.wave_of.get(n.op_id)
                if w is None:
                    continue
                for e in heads_of_wave.get(w + 1, ()):
                    succ[self.done[n.op_id]].append(e)
        self.succ = succ

    def toposort(self) -> Optional[List[int]]:
        indeg = [0] * self.nevents
        for v in range(self.nevents):
            for w in self.succ[v]:
                indeg[w] += 1
        ready = [v for v in range(self.nevents) if indeg[v] == 0]
        order: List[int] = []
        while ready:
            v = ready.pop()
            order.append(v)
            for w in self.succ[v]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    ready.append(w)
        return order if len(order) == self.nevents else None

    def closure(self, order: List[int]) -> List[int]:
        """reach[v] = bitmask of events reachable from v (v included)."""
        reach = [0] * self.nevents
        for v in reversed(order):
            r = 1 << v
            for w in self.succ[v]:
                r |= reach[w]
            reach[v] = r
        return reach


def _data_accesses(n: TriggeredOp) -> List[Tuple[str, str, str]]:
    """[(when, buffer, mode)] data-buffer footprint of one op; ``when``
    is "issue"/"done", ``mode`` "r"/"w". Counters are excluded (atomic
    bumps/polls — see module docstring)."""
    if n.kind == "kernel":
        return ([("issue", b, "r") for b in n.reads]
                + [("issue", b, "w") for b in n.writes])
    if n.kind == "put":
        srcs = n.srcs or ((n.src,) if n.src else ())
        dsts = n.dsts or ((n.dst,) if n.dst else ())
        acc: List[Tuple[str, str, str]] = []
        for b in srcs:
            acc += [("issue", b, "r"), ("done", b, "r")]
        acc += [("done", b, "w") for b in dsts]
        return acc
    if n.kind == "wait":
        # the fence: readers of the delivered buffers must follow it
        return ([("issue", b, "r") for b in n.writes]
                + [("issue", b, "w") for b in n.writes])
    return []


def _chunks_disjoint(a: TriggeredOp, b: TriggeredOp) -> bool:
    """Chunks of ONE chain touch disjoint element slices of their
    logical payload — they never race each other (overlap is bad-chunk
    lint, not a race)."""
    if a.kind != "put" or b.kind != "put":
        return False
    if a.chunk_head < 0 or a.chunk_head != b.chunk_head:
        return False
    a0, a1 = a.chunk_offset, a.chunk_offset + a.chunk_elems
    b0, b1 = b.chunk_offset, b.chunk_offset + b.chunk_elems
    return a1 <= b0 or b1 <= a0


# ---------------------------------------------------------------------------
# pass 0: structural sanity (duplicate ids / self-deps / dangling edges)
# ---------------------------------------------------------------------------

def _structure_pass(prog: TriggeredProgram,
                    findings: List[Finding]) -> bool:
    """The invariants the HB builder itself leans on; mirrors (and
    subsumes) schedule.validate_deps as findings instead of raises.
    Returns False only when op IDENTITY is broken (duplicate op_ids):
    dangling edges are skipped by the event-graph builder and
    self-dependencies surface as event cycles, so analysis continues
    past both — a truncated chunk chain should still get its bad-chunk
    finding even though the dropped tail leaves dangling edges."""
    seen: Dict[int, TriggeredOp] = {}
    ok = True
    for n in prog.nodes:
        if n.op_id in seen:
            findings.append(Finding(
                "bad-deps", "error",
                f"duplicate op_id {n.op_id}: {_label(seen[n.op_id])} and "
                f"{_label(n)} — dependency edges become ambiguous",
                (n.op_id,), (_label(seen[n.op_id]), _label(n))))
            ok = False
        seen[n.op_id] = n
    for n in prog.nodes:
        if n.op_id in n.deps:
            findings.append(Finding(
                "bad-deps", "error",
                f"{_label(n)} depends on itself — can never fire",
                (n.op_id,), (_label(n),)))
        for d in n.deps:
            if d not in seen:
                findings.append(Finding(
                    "bad-deps", "error",
                    f"{_label(n)} has dangling dependency edge {d} "
                    "(no such op in this program)",
                    (n.op_id,), (_label(n),)))
    return ok


# ---------------------------------------------------------------------------
# pass 1: happens-before race detection
# ---------------------------------------------------------------------------

def _race_pass(prog: TriggeredProgram, ev: _EventGraph,
               reach: List[int], findings: List[Finding],
               checked: Dict[str, int]):
    by_buf: Dict[str, List[tuple]] = defaultdict(list)
    for n in prog.nodes:
        for when, buf, mode in _data_accesses(n):
            if not buf or _is_counter(buf):
                continue
            e = ev.issue[n.op_id] if when == "issue" else ev.done[n.op_id]
            by_buf[buf].append((e, mode, n))
    pairs = 0
    reported = set()
    for buf, accs in sorted(by_buf.items()):
        for i, (ei, mi, ni) in enumerate(accs):
            for ej, mj, nj in accs[i + 1:]:
                if ni.op_id == nj.op_id:
                    continue
                if mi == "r" and mj == "r":
                    continue
                if _chunks_disjoint(ni, nj):
                    continue
                pairs += 1
                if (reach[ei] >> ej) & 1 or (reach[ej] >> ei) & 1:
                    continue
                key = (buf, min(ni.op_id, nj.op_id),
                       max(ni.op_id, nj.op_id))
                if key in reported:
                    continue
                reported.add(key)
                conflict = {"ww": "write/write", "rw": "read/write",
                            "wr": "write/read"}[mi + mj]
                findings.append(Finding(
                    "race", "error",
                    f"unordered {conflict} on {buf!r}: {_label(ni)} vs "
                    f"{_label(nj)} — no happens-before path in either "
                    "direction",
                    (ni.op_id, nj.op_id),
                    (_label(ni), f"?? {buf} ??", _label(nj))))
    checked["conflict_pairs"] = checked.get("conflict_pairs", 0) + pairs


# ---------------------------------------------------------------------------
# pass 2: deadlock / liveness
# ---------------------------------------------------------------------------

_SLOT_RE = re.compile(r"^(.*)\[(\d+)\]$")


def _liveness_pass(prog: TriggeredProgram, findings: List[Finding],
                   checked: Dict[str, int]):
    puts = prog.puts()
    by_we = defaultdict(list)
    for p in puts:
        by_we[(p.window, p.epoch)].append(p)
    nwaits = 0
    for w in prog.nodes:
        if w.kind != "wait" or w.expected_puts < 0:
            continue
        nwaits += 1
        epoch_puts = by_we.get((w.window, w.epoch), [])
        cands = [p for p in epoch_puts if p.chained is not None
                 and p.chained.counter == w.counter]
        strays = len(epoch_puts) - len(cands)
        if len(cands) < w.expected_puts:
            hint = (f" ({strays} put(s) of this epoch signal a DIFFERENT "
                    "counter — ping/pong parity mismatch?)" if strays
                    else "")
            findings.append(Finding(
                "unsatisfiable-wait", "error",
                f"{_label(w)} expects {w.expected_puts} completion(s) on "
                f"{w.counter!r} but only {len(cands)} chained signal(s) "
                f"can reach it — the wait kernel spins forever{hint}",
                (w.op_id,) + tuple(p.op_id for p in cands),
                (_label(w),)))
        elif len(cands) > w.expected_puts:
            findings.append(Finding(
                "phantom-completion", "error",
                f"{_label(w)} expects {w.expected_puts} completion(s) on "
                f"{w.counter!r} but {len(cands)} chained signal(s) bump "
                "it — the wait resolves before the payload landed",
                (w.op_id,) + tuple(p.op_id for p in cands),
                (_label(w),)))
    checked["waits"] = checked.get("waits", 0) + nwaits

    # trigger satisfiability: by SPMD symmetry the local program's post
    # bumps to (counter, slot) stand in for the neighbor's arriving
    # signals (the group is closed under its opposite involution)
    bumps: Dict[tuple, int] = defaultdict(int)
    for n in prog.nodes:
        if n.kind != "signal" or n.role != "post":
            continue
        if n.slots:
            for slot, _d in n.slots:
                bumps[(n.counter, slot)] += 1
        elif n.slot >= 0:
            bumps[(n.counter, n.slot)] += 1
    for p in puts:
        m = _SLOT_RE.match(p.trigger_counter or "")
        if not m:
            continue
        counter, slot = m.group(1), int(m.group(2))
        have = bumps.get((counter, slot), 0)
        if have < p.threshold:
            findings.append(Finding(
                "unsatisfiable-trigger", "error",
                f"{_label(p)} is armed by {counter!r}[{slot}] reaching "
                f"{p.threshold}, but the program only posts {have} "
                "signal(s) to that slot — the descriptor never fires",
                (p.op_id,), (_label(p),)))


def _cycle_finding(prog: TriggeredProgram, ev: _EventGraph) -> Finding:
    """Witness cycle of a non-DAG event graph (deps + stream order +
    counter joins): nothing on it can make progress."""
    cyc = find_cycle(range(ev.nevents), lambda v: ev.succ[v])
    labels: List[str] = []
    op_ids: List[int] = []
    for v in (cyc or []):
        n = ev.ev_node[v]
        split = ev.done.get(n.op_id) != ev.issue[n.op_id]
        tag = _label(n) + (".done" if split
                           and v == ev.done.get(n.op_id) else "")
        if not labels or labels[-1] != tag:
            labels.append(tag)
            op_ids.append(n.op_id)
    return Finding(
        "deadlock-cycle", "error",
        "the event graph (dependency edges + per-stream program order + "
        "counter joins) has a cycle — every op on it waits for the "
        "others and the program deadlocks",
        tuple(dict.fromkeys(op_ids)), tuple(labels))


# ---------------------------------------------------------------------------
# pass 3: descriptor well-formedness lint
# ---------------------------------------------------------------------------

def _lint_pass(prog: TriggeredProgram, findings: List[Finding],
               checked: Dict[str, int]):
    import numpy as np

    for p in prog.puts():
        win = prog.windows.get(p.window)
        topo = getattr(win, "topology", None)
        # perm bijectivity on the rank grid
        if p.perm:
            srcs = [s for s, _ in p.perm]
            dsts = [d for _, d in p.perm]
            grid = getattr(topo, "grid_shape", None)
            nranks = (int(np.prod(grid)) if grid else len(p.perm))
            want = set(range(nranks))
            if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
                    or set(srcs) != want or set(dsts) != want):
                findings.append(Finding(
                    "bad-perm", "error",
                    f"{_label(p)} permutation is not a bijection on the "
                    f"{nranks}-rank grid (srcs={sorted(set(srcs))[:8]}, "
                    f"dsts={sorted(set(dsts))[:8]})",
                    (p.op_id,), (_label(p),)))
        # packed multi-buffer descriptors
        if p.srcs:
            dup = (len(set(p.srcs)) != len(p.srcs)
                   or len(set(p.dsts)) != len(p.dsts))
            if len(p.srcs) != len(p.dsts) or dup or not p.dtype:
                findings.append(Finding(
                    "bad-pack", "error",
                    f"{_label(p)} packed descriptor malformed: "
                    f"{len(p.srcs)} src(s) / {len(p.dsts)} dst(s), "
                    f"dtype={p.dtype!r} — buffer lists must pair up, be "
                    "distinct, and agree on dtype for the staging concat",
                    (p.op_id,), (_label(p),)))
        # multicast branch sets
        if p.mcast_dirs:
            group = tuple(map(tuple, getattr(win, "group", ()) or ()))
            bad = [d for d in p.mcast_dirs if tuple(d) not in group] \
                if group else []
            pairs_ok = len(p.dsts) == len(p.mcast_dirs)
            slots_ok = True
            if win is not None and p.chained is not None:
                want = sorted((win.opposite_index(d), tuple(d))
                              for d in p.mcast_dirs)
                have = sorted((s, tuple(d))
                              for s, d in (p.chained.slots or ()))
                slots_ok = want == have
            if bad or not pairs_ok or not slots_ok:
                findings.append(Finding(
                    "bad-mcast", "error",
                    f"{_label(p)} multicast branches inconsistent with "
                    f"topology: {len(p.mcast_dirs)} branch(es), "
                    f"{len(p.dsts)} landing buffer(s), "
                    f"{len(bad)} direction(s) outside the group, "
                    "completion-tree slots "
                    f"{'ok' if slots_ok else 'MISMATCHED'}",
                    (p.op_id,), (_label(p),)))

    # chunk chains must tile the logical payload exactly
    chains: Dict[int, List[TriggeredOp]] = defaultdict(list)
    for p in prog.puts():
        if p.chunk_head >= 0:
            chains[p.chunk_head].append(p)
    for head, chain in sorted(chains.items()):
        chain.sort(key=lambda c: (c.chunk_index, c.op_id))
        count = chain[0].chunk_count
        idxs = [c.chunk_index for c in chain]
        problems = []
        if any(c.chunk_count != count for c in chain):
            problems.append("chunk_count disagrees across the chain")
        if idxs != list(range(count)):
            problems.append(
                f"chain has indices {idxs} (want 0..{count - 1}: "
                "truncated, duplicated, or reordered)")
        else:
            if chain[0].chunk_offset != 0:
                problems.append(
                    f"first chunk starts at element {chain[0].chunk_offset}")
            for a, b in zip(chain, chain[1:]):
                expect = a.chunk_offset + a.chunk_elems
                if b.chunk_offset != expect:
                    problems.append(
                        f"gap/overlap at chunk {b.chunk_index}: offset "
                        f"{b.chunk_offset}, previous chunk ends at {expect}")
                    break
        if any(c.chunk_elems <= 0 for c in chain):
            problems.append("chunk with a non-positive element count")
        if len({(c.window, c.epoch) for c in chain}) > 1:
            problems.append("chain spans windows/epochs")
        if problems:
            findings.append(Finding(
                "bad-chunk", "error",
                f"chunk chain of {_label(chain[0])}: "
                + "; ".join(problems),
                tuple(c.op_id for c in chain),
                tuple(_label(c) for c in chain)))
    checked["chunk_chains"] = checked.get("chunk_chains", 0) + len(chains)

    # counter-slot bounds: every signal lands on a slot the window's
    # counter buffers actually have
    for n in prog.nodes:
        sigs: List[TriggeredOp] = []
        if n.kind == "signal":
            sigs.append(n)
        if n.kind == "put" and n.chained is not None:
            sigs.append(n.chained)
        if n.kind == "wait":
            win = prog.windows.get(n.window)
            if win is not None and n.counter not in win.counter_names():
                findings.append(Finding(
                    "bad-slot", "error",
                    f"{_label(n)} polls counter {n.counter!r} which window "
                    f"{n.window!r} does not allocate",
                    (n.op_id,), (_label(n),)))
        for s in sigs:
            win = prog.windows.get(s.window)
            if win is None:
                continue
            npeers = len(win.group)
            slots = [sl for sl, _d in s.slots] if s.slots \
                else ([s.slot] if s.slot >= 0 else [])
            for sl in slots:
                if not 0 <= sl < npeers:
                    findings.append(Finding(
                        "bad-slot", "error",
                        f"{_label(n)} signals slot {sl} of {s.counter!r} "
                        f"— window {s.window!r} has {npeers} peer slot(s)",
                        (n.op_id,), (_label(n),)))
            if s.counter and s.counter not in win.counter_names():
                findings.append(Finding(
                    "bad-slot", "error",
                    f"{_label(n)} bumps counter {s.counter!r} which window "
                    f"{s.window!r} does not allocate",
                    (n.op_id,), (_label(n),)))


# ---------------------------------------------------------------------------
# pass 4: resource safety
# ---------------------------------------------------------------------------

def _resource_pass(prog: TriggeredProgram, ev: _EventGraph,
                   reach: List[int], findings: List[Finding],
                   checked: Dict[str, int]):
    resources = prog.meta.get("resources")
    in_flight: List[TriggeredOp] = []
    high = 0
    high_at: Optional[Tuple[TriggeredOp, Tuple[TriggeredOp, ...]]] = None
    for p in prog.nodes:
        if p.kind != "put":
            continue
        ip = ev.issue[p.op_id]
        in_flight = [q for q in in_flight
                     if not (reach[ev.done[q.op_id]] >> ip) & 1]
        in_flight.append(p)
        if len(in_flight) > high:
            high, high_at = len(in_flight), (p, tuple(in_flight))
    checked["slot_high_water"] = max(
        checked.get("slot_high_water", 0), high)
    if resources is not None and high > resources \
            and high_at is not None:
        p, flight = high_at
        findings.append(Finding(
            "slot-overflow", "error",
            f"descriptor-slot high water {high} exceeds the throttle "
            f"policy's resources={resources}: at {_label(p)}'s issue, "
            f"{high - 1} earlier put(s) are not provably complete — the "
            "NIC's finite triggered-op slots wedge",
            tuple(q.op_id for q in flight),
            tuple(_label(q) for q in flight[:8])
            + (("...",) if len(flight) > 8 else ())))


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def verify(prog: TriggeredProgram) -> VerifyReport:
    """Run all four static pass families over one scheduled program."""
    findings: List[Finding] = []
    checked: Dict[str, int] = {"nodes": len(prog.nodes), "programs": 1}
    if not _structure_pass(prog, findings):
        # op identity is broken; the HB model would be meaningless
        return VerifyReport(findings, checked)
    ev = _EventGraph(prog)
    checked["events"] = ev.nevents
    order = ev.toposort()
    if order is None:
        findings.append(_cycle_finding(prog, ev))
    else:
        reach = ev.closure(order)
        _race_pass(prog, ev, reach, findings, checked)
        _resource_pass(prog, ev, reach, findings, checked)
    _liveness_pass(prog, findings, checked)
    _lint_pass(prog, findings, checked)
    return VerifyReport(findings, checked)


def verify_programs(progs: Sequence[TriggeredProgram]) -> VerifyReport:
    """Verify a host_sync-split pipeline; one merged report."""
    report = VerifyReport(checked={"programs": 0})
    for prog in progs:
        report.merge(verify(prog))
    return report


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.core.verify
# ---------------------------------------------------------------------------

# per-pattern defaults for --all: small device-free builds with a node
# mapping so the inter-link passes (pack/chunk/node_aware) have work
_CLI_GRIDS = {"faces": (2, 2, 2), "ring": (4,), "a2a": (4,),
              "broadcast": (2, 4), "serve": (4,)}
_CLI_RPN = {"faces": 4, "ring": 2, "a2a": 2, "broadcast": 2, "serve": 2}
_CLI_BUILD = {"faces": {"n": (4, 4, 4)}}


def _cli_programs(pattern: str, cfg, niter: int, grid, rpn):
    from repro_torch.core.patterns import pattern_programs

    kw = dict(_CLI_BUILD.get(pattern, {}))
    return pattern_programs(pattern, niter, grid=grid,
                            ranks_per_node=rpn, config=cfg, **kw)


def _verify_space(patterns, niter: int, full: bool, quiet: bool) -> int:
    from repro_torch.core.autotune import search_space

    failures = 0
    for pat in patterns:
        grid, rpn = _CLI_GRIDS.get(pat), _CLI_RPN.get(pat)
        space = search_space(pat, rpn, full=full)
        clean = 0
        for cfg in space:
            report = verify_programs(
                _cli_programs(pat, cfg, niter, grid, rpn))
            if report.ok and not report.findings:
                clean += 1
            else:
                failures += 1
                print(f"FAIL {pat} [{cfg.label()}]: {report.summary()}")
        if not quiet:
            print(f"{pat}: {clean}/{len(space)} configs verify clean")
    return failures


def _verify_mutations(quiet: bool) -> int:
    from repro_torch.core.defects import run_corpus

    failures = 0
    for name, res in run_corpus().items():
        status = "caught" if res["detected"] else "MISSED"
        if not res["detected"]:
            failures += 1
        if not quiet or not res["detected"]:
            print(f"{name}: {status} (expected {res['expected_kind']}, "
                  f"got {sorted(res['kinds'])})")
    return failures


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.verify",
        description="Statically verify scheduled triggered-op programs "
                    "(races, deadlock/liveness, descriptor lint, "
                    "resource safety) without executing them.")
    ap.add_argument("--pattern", default=None,
                    help="verify one pattern (default: all four across "
                         "the autotune quick search space)")
    ap.add_argument("--niter", type=int, default=3)
    ap.add_argument("--grid", default=None,
                    help="comma-separated grid, e.g. 2,2,2")
    ap.add_argument("--rpn", type=int, default=None,
                    help="ranks per node (enables inter-node links)")
    ap.add_argument("--full", action="store_true",
                    help="use the full (weekly) search space")
    ap.add_argument("--mutations", action="store_true",
                    help="also run the seeded-defect corpus and require "
                         "every mutation class to be caught")
    ap.add_argument("--quiet", action="store_true")
    # single-config knobs (only with --pattern)
    ap.add_argument("--throttle", default="adaptive")
    ap.add_argument("--resources", type=int, default=16)
    ap.add_argument("--nstreams", type=int, default=1)
    ap.add_argument("--double_buffer", type=int, default=0)
    ap.add_argument("--node_aware", type=int, default=0)
    ap.add_argument("--pack", type=int, default=0)
    ap.add_argument("--chunk_bytes", type=int, default=0)
    ap.add_argument("--fused", type=int, default=0)
    args = ap.parse_args(argv)

    failures = 0
    if args.pattern:
        from repro_torch.core.autotune import ScheduleConfig

        grid = (tuple(int(x) for x in args.grid.split(","))
                if args.grid else _CLI_GRIDS.get(args.pattern))
        rpn = args.rpn if args.rpn is not None \
            else _CLI_RPN.get(args.pattern)
        cfg = ScheduleConfig(
            throttle=args.throttle, resources=args.resources,
            nstreams=args.nstreams,
            double_buffer=bool(args.double_buffer),
            node_aware=bool(args.node_aware), pack=bool(args.pack),
            chunk_bytes=args.chunk_bytes, fused=bool(args.fused))
        report = verify_programs(
            _cli_programs(args.pattern, cfg, args.niter, grid, rpn))
        print(f"{args.pattern} [{cfg.label()}]: {report.summary()}")
        failures += 0 if report.ok and not report.findings else 1
    else:
        from repro_torch.core.patterns import available_patterns

        failures += _verify_space(available_patterns(), args.niter,
                                  args.full, args.quiet)
    if args.mutations:
        failures += _verify_mutations(args.quiet)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
