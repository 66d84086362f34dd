"""Seeded-defect mutation corpus for the static schedule verifier.

Each mutation plants ONE representative schedule defect into a freshly
built clean program and asserts :func:`repro_torch.core.verify.verify`
reports it with the right finding kind — the other half of the
verifier's contract (the clean half is the all-patterns x quick-space
zero-findings test). The classes mirror the real bug surface of the
schedule passes:

  * ``drop-conflict-edge``   — assign_streams loses a cross-stream
    conflict edge: a compute kernel reads a delivered buffer unordered
    with the wait fence / put completion             -> ``race``
  * ``corrupt-expected-puts`` — a wait's threshold exceeds the chained
    signals that can reach its counter               -> ``unsatisfiable-wait``
  * ``phantom-expected-puts`` — the dual: more signals than the wait
    expects, releasing it before delivery           -> ``phantom-completion``
  * ``swap-parity``          — a pong epoch's chained completion
    signals bump the PING counter, starving the pong wait
                                                     -> ``unsatisfiable-wait``
  * ``truncate-chunk-chain`` — the tail chunk of a pipelined chain is
    dropped: the payload has a hole                  -> ``bad-chunk``
  * ``overflow-resources``   — throttle edges stripped while the policy
    still claims finite slots                        -> ``slot-overflow``

Every ``apply`` mutates IN PLACE and returns the op_ids it touched
(empty tuple = mutation not applicable, a corpus bug). Builders use
small device-free programs via ``pattern_programs`` — same pipeline
the executors consume.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

from repro_torch.core.triggered import TriggeredProgram
from repro_torch.core.verify import VerifyReport, verify

_PONG = "__pp"      # mirrors repro_torch.core.window.PONG (torch-free module)


@dataclass(frozen=True)
class Mutation:
    """One seeded defect: how to build the clean program, how to break
    it, and which finding kind the verifier must report."""
    name: str
    expected_kind: str
    build: Callable[[], TriggeredProgram]
    apply: Callable[[TriggeredProgram], Tuple[int, ...]]
    doc: str = ""


def _program(pattern: str, niter: int, **kw) -> TriggeredProgram:
    from repro_torch.core.patterns import pattern_programs

    progs = pattern_programs(pattern, niter, **kw)
    assert len(progs) == 1, "corpus builders must not host_sync-split"
    return progs[0]


# -- builders (small, deterministic, single-segment) ------------------------

def _faces_two_stream() -> TriggeredProgram:
    return _program("faces", 3, grid=(2, 2, 2), n=(4, 4, 4), nstreams=2)


def _ring_double_buffered() -> TriggeredProgram:
    return _program("ring", 4, grid=(4,), nstreams=2, double_buffer=True)


def _ring_chunked() -> TriggeredProgram:
    # 256-byte KV blocks over 64-byte chunks -> 4-chunk chains
    return _program("ring", 2, grid=(4,), ranks_per_node=2, chunk_bytes=64)


def _faces_throttled() -> TriggeredProgram:
    # 26 puts per epoch against 4 descriptor slots: the adaptive edges
    # carry the whole resource proof
    return _program("faces", 2, grid=(2, 2, 2), n=(4, 4, 4),
                    throttle="adaptive", resources=4)


# -- mutations --------------------------------------------------------------

def _drop_conflict_edge(prog: TriggeredProgram) -> Tuple[int, ...]:
    """Remove the cross-stream dep edge ordering a compute kernel after
    its epoch's wait — exactly what assign_streams exists to emit."""
    by_id = {n.op_id: n for n in prog.nodes}
    for n in prog.nodes:
        if n.kind != "kernel":
            continue
        for d in n.deps:
            dep = by_id.get(d)
            if dep is not None and dep.kind == "wait" \
                    and dep.stream != n.stream:
                n.deps = tuple(x for x in n.deps if x != d)
                return (n.op_id, d)
    return ()


def _corrupt_expected_puts(prog: TriggeredProgram) -> Tuple[int, ...]:
    for n in prog.nodes:
        if n.kind == "wait" and n.expected_puts > 0:
            n.expected_puts += 1
            return (n.op_id,)
    return ()


def _phantom_expected_puts(prog: TriggeredProgram) -> Tuple[int, ...]:
    for n in prog.nodes:
        if n.kind == "wait" and n.expected_puts > 1:
            n.expected_puts -= 1
            return (n.op_id,)
    return ()


def _swap_parity(prog: TriggeredProgram) -> Tuple[int, ...]:
    """Flip one pong epoch's chained completion signals onto the PING
    counter: the payload still lands in the pong buffers, but the bump
    arrives on the wrong parity, so the pong wait starves. (Redirecting
    the payload instead would NOT race in these builders — adjacent
    epochs serialize through the compute stream — so the honest static
    symptom of a parity swap is liveness, not a data race.)"""
    pong_epochs = sorted({n.epoch for n in prog.nodes
                          if n.kind == "put" and n.phase % 2
                          and n.chained is not None
                          and n.chained.counter.endswith(_PONG)})
    if not pong_epochs:
        return ()
    target = pong_epochs[len(pong_epochs) // 2]
    touched: List[int] = []
    for n in prog.nodes:
        if n.kind != "put" or n.epoch != target or not n.phase % 2:
            continue
        if n.chained is not None and n.chained.counter.endswith(_PONG):
            n.chained.counter = n.chained.counter[:-len(_PONG)]
            touched.append(n.op_id)
    return tuple(touched)


def _truncate_chunk_chain(prog: TriggeredProgram) -> Tuple[int, ...]:
    chains: Dict[int, List] = {}
    for p in prog.puts():
        if p.chunk_head >= 0:
            chains.setdefault(p.chunk_head, []).append(p)
    for head in sorted(chains):
        chain = sorted(chains[head], key=lambda c: c.chunk_index)
        if len(chain) > 1:
            tail = chain[-1]
            prog.nodes = [n for n in prog.nodes
                          if n.op_id != tail.op_id]
            # a pass that drops a chunk remaps edges cleanly; keep the
            # defect purely a payload hole, not a dangling-edge lint
            for n in prog.nodes:
                if tail.op_id in n.deps:
                    n.deps = tuple(d for d in n.deps if d != tail.op_id)
            return (tail.op_id,)
    return ()


def _overflow_resources(prog: TriggeredProgram) -> Tuple[int, ...]:
    """Strip every put->put throttle edge while meta still claims the
    finite-slot policy — the schedule can now wedge the NIC."""
    put_ids = {p.op_id for p in prog.puts()}
    touched = []
    for p in prog.puts():
        kept = tuple(d for d in p.deps if d not in put_ids)
        if kept != p.deps:
            p.deps = kept
            touched.append(p.op_id)
    return tuple(touched)


MUTATIONS: Tuple[Mutation, ...] = (
    Mutation("drop-conflict-edge", "race",
             _faces_two_stream, _drop_conflict_edge,
             "lost assign_streams conflict edge"),
    Mutation("corrupt-expected-puts", "unsatisfiable-wait",
             _faces_two_stream, _corrupt_expected_puts,
             "wait threshold above reachable completions"),
    Mutation("phantom-expected-puts", "phantom-completion",
             _faces_two_stream, _phantom_expected_puts,
             "wait threshold below arriving completions"),
    Mutation("swap-parity", "unsatisfiable-wait",
             _ring_double_buffered, _swap_parity,
             "pong epoch signals the ping parity's counter"),
    Mutation("truncate-chunk-chain", "bad-chunk",
             _ring_chunked, _truncate_chunk_chain,
             "chunk chain with a missing tail"),
    Mutation("overflow-resources", "slot-overflow",
             _faces_throttled, _overflow_resources,
             "throttle edges stripped under a finite-slot policy"),
)


def mutations() -> Dict[str, Mutation]:
    return {m.name: m for m in MUTATIONS}


def run_mutation(m: Mutation) -> Tuple[VerifyReport, Tuple[int, ...]]:
    """Build the clean program, verify it IS clean, plant the defect,
    and re-verify. Returns (mutated report, touched op_ids)."""
    prog = m.build()
    baseline = verify(prog)
    if baseline.findings:
        raise AssertionError(
            f"corpus builder for {m.name!r} is not clean: "
            f"{baseline.summary()}")
    touched = m.apply(prog)
    if not touched:
        raise AssertionError(
            f"mutation {m.name!r} found nothing to mutate — builder "
            "and mutation drifted apart")
    return verify(prog), touched


def run_corpus() -> Dict[str, dict]:
    """Run every mutation; each entry reports whether the expected
    finding kind was produced and with what witness."""
    out: Dict[str, dict] = {}
    for m in MUTATIONS:
        report, touched = run_mutation(m)
        hits = [f for f in report.findings if f.kind == m.expected_kind]
        out[m.name] = {
            "expected_kind": m.expected_kind,
            "detected": bool(hits),
            "kinds": sorted({f.kind for f in report.findings}),
            "touched": list(touched),
            "witness": list(hits[0].witness) if hits else [],
        }
    return out
