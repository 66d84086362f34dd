"""The port's static schedule verifier (core/verify.py) and seeded-defect
corpus (core/defects.py) against the JAX package's.

Both are pure Python over the triggered-op IR, so the port's must give
exactly the reference's results: the CLI's lines with ``--mutations``
(every pattern across the tuner's quick search space verifies clean,
every seeded defect is caught with the reference's finding kinds), the
per-pattern ``checked`` counts, the corpus' kinds, touched op ids and
witnesses; ``schedule(verify=True)`` runs it. Also the reference's own
cases for ``validate_deps``, ``find_cycle`` and the report's
``merge``/``summary`` (``tests/test_verify.py``), held on the port.
"""
import itertools
import sys

import pytest

pytest.importorskip("torch")

from repro.core import defects as j_defects
from repro.core.autotune import search_space as j_search_space
from repro.core.patterns import pattern_programs as j_pattern_programs
from repro.core.verify import main as j_main
from repro.core.verify import verify_programs as j_verify_programs
from repro_torch.core import (ScheduleVerificationError, find_cycle,
                              pattern_programs, verify, verify_programs)
from repro_torch.core import defects
from repro_torch.core.autotune import search_space
from repro_torch.core.schedule import schedule, validate_deps
from repro_torch.core.triggered import TriggeredOp, TriggeredProgram
from repro_torch.core.verify import (_CLI_BUILD, _CLI_GRIDS, _CLI_RPN,
                                     VerifyReport, main)

PATTERNS = ["a2a", "broadcast", "faces", "ring", "serve"]


@pytest.fixture
def aligned_ids(monkeypatch):
    """Both packages' op-id counters restarted at one value: op ids are
    drawn from a per-process counter, which the tests run before in the
    same process advance by different amounts in the two packages."""
    for name in ("repro.core.triggered", "repro_torch.core.triggered"):
        monkeypatch.setattr(sys.modules[name], "_ids", itertools.count(0))


def _op(i, deps=(), stream=0, kind="kernel"):
    return TriggeredOp(kind=kind, op_id=i, deps=tuple(deps),
                       stream=stream)


def _prog(nodes):
    return TriggeredProgram(nodes=nodes)


def test_cli_output_equals_the_reference(capsys):
    """``python -m repro_torch.core.verify --mutations`` prints the
    reference's lines: 1152 configs clean across the five patterns, six
    mutations caught with the reference's kinds."""
    assert j_main(["--mutations"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert main(["--mutations"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert sum(int(line.split()[1].split("/")[0]) for line in got
               if "configs verify clean" in line) == 1152
    assert sum(": caught (" in line for line in got) == 6


@pytest.mark.parametrize("pattern", PATTERNS)
def test_quick_space_checked_counts_equal_the_reference(pattern):
    """Over the quick search space, the port's programs verify clean with
    the reference's counts (ops, events, conflict pairs, ...) config by
    config."""
    grid, rpn = _CLI_GRIDS[pattern], _CLI_RPN[pattern]
    kw = dict(_CLI_BUILD.get(pattern, {}))
    space, jspace = search_space(pattern, rpn), j_search_space(pattern, rpn)
    assert [c.label() for c in space] == [c.label() for c in jspace]
    for cfg, jcfg in zip(space, jspace):
        got = verify_programs(pattern_programs(
            pattern, 2, grid=grid, ranks_per_node=rpn, config=cfg, **kw))
        want = j_verify_programs(j_pattern_programs(
            pattern, 2, grid=grid, ranks_per_node=rpn, config=jcfg, **kw))
        assert got.ok and not got.findings, (cfg.label(), got.summary())
        assert not want.findings
        assert got.checked == want.checked, cfg.label()


@pytest.mark.parametrize("name", [m.name for m in defects.MUTATIONS])
def test_mutation_equals_the_reference(name, aligned_ids):
    """Each seeded defect: the same op ids touched, the same findings
    (kind, severity, op ids, witness, message) as the reference's, the
    expected kind among them."""
    m, jm = defects.mutations()[name], j_defects.mutations()[name]
    assert m.expected_kind == jm.expected_kind
    report, touched = defects.run_mutation(m)
    jreport, jtouched = j_defects.run_mutation(jm)
    assert touched == jtouched
    assert m.expected_kind in report.kinds()
    assert [(f.kind, f.severity, f.op_ids, f.witness, f.message)
            for f in report.findings] == \
        [(f.kind, f.severity, f.op_ids, f.witness, f.message)
         for f in jreport.findings]


def test_corpus_equals_the_reference(aligned_ids):
    got, want = defects.run_corpus(), j_defects.run_corpus()
    assert got == want
    assert all(r["detected"] for r in got.values())
    assert got["swap-parity"]["kinds"] == ["race", "unsatisfiable-wait"]
    assert got["truncate-chunk-chain"]["kinds"] == ["bad-chunk",
                                                    "unsatisfiable-wait"]


def _raw_ring_segment():
    from repro_torch.core.lower import lower_segment, split_segments
    from repro_torch.core.patterns import get_pattern
    from repro_torch.core.stream import STStream

    p = get_pattern("ring")
    stream = STStream(None, p.grid_axes, grid_shape=(4,))
    p.build(stream, 2, merged=True, double_buffer=False,
            ranks_per_node=None, batch=1, seq_per_rank=8, heads=2,
            head_dim=8)
    seg = split_segments(stream.program)[0]
    return lower_segment(stream, seg)


def test_schedule_verify_kwarg_clean():
    prog = schedule(_raw_ring_segment(), nstreams=2, verify=True)
    assert prog.nodes


def test_schedule_verify_kwarg_raises_on_defect(monkeypatch):
    """A defect planted by a schedule pass (the threshold of a wait one
    above its completions) makes ``schedule(verify=True)`` raise."""
    # the package's ``schedule`` attribute is the function, not the module
    sched = sys.modules["repro_torch.core.schedule"]
    inner = sched.validate_deps

    def corrupt(prog):
        prog = inner(prog)
        wait = next(n for n in prog.nodes
                    if n.kind == "wait" and n.expected_puts > 0)
        wait.expected_puts += 1
        return prog
    monkeypatch.setattr(sched, "validate_deps", corrupt)
    with pytest.raises(ScheduleVerificationError,
                       match="unsatisfiable-wait"):
        schedule(_raw_ring_segment(), nstreams=2, verify=True)
    schedule(_raw_ring_segment(), nstreams=2)       # unverified: no raise


def test_report_merge_and_summary():
    r1, r2 = verify(_raw_ring_segment()), VerifyReport()
    assert r1.ok and "clean" in r1.summary()
    merged = r2.merge(r1)
    assert merged.checked.get("nodes") == r1.checked["nodes"]


@pytest.mark.parametrize("nodes,match", [
    ([_op(0), _op(1, deps=(1,))], "self-dep"),
    ([_op(0), _op(0)], "duplicate op_id"),
    ([_op(0, deps=(99,))], "dangling"),
], ids=["self-dependency", "duplicate-op-ids", "dangling-edges"])
def test_validate_deps_rejects(nodes, match):
    with pytest.raises(ValueError, match=match):
        validate_deps(_prog(nodes))


def test_validate_deps_accepts_clean_program():
    p = _prog([_op(0), _op(1, deps=(0,))])
    assert validate_deps(p) is p


@pytest.mark.parametrize("succ,cycle", [
    ({0: [1], 1: [2], 2: []}, None),
    ({0: [1], 1: [2], 2: [1], 3: []}, {1, 2}),
], ids=["acyclic", "closed-witness"])
def test_find_cycle(succ, cycle):
    cyc = find_cycle(succ, lambda v: succ[v])
    if cycle is None:
        assert cyc is None
    else:
        assert cyc is not None and cyc[0] == cyc[-1]
        assert set(cyc) == cycle


def test_cli_single_pattern_clean(capsys):
    rc = main(["--pattern", "ring", "--nstreams", "2", "--niter", "2"])
    out = capsys.readouterr().out
    assert rc == 0 and "clean" in out


def test_faces_64_ranks_verify_clean_in_seconds():
    """The 64-rank Faces program the card runs (4x4x4 ranks, 20
    iterations, 16 descriptor slots; plain and fused schedules):
    clean, and the reachability closure stays well within seconds."""
    import time

    from repro_torch.core import STStream, halo
    for fused in (False, True):
        stream = STStream(None, ("x", "y", "z"), grid_shape=(4, 4, 4))
        halo.build_faces_program(stream, (64, 64, 64), 20)
        progs = stream.scheduled_programs(resources=16, fused=fused)
        t0 = time.perf_counter()
        report = verify_programs(progs)
        assert time.perf_counter() - t0 < 10.0
        assert report.ok and not report.findings, report.summary()
        assert report.checked["nodes"] == sum(len(p.nodes) for p in progs)
