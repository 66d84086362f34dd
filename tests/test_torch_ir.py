"""Device-free parity of the port's IR, schedule passes and simulator
with the JAX package, on Faces.

For every schedule setting below, ``repro_torch`` and ``repro`` lower and
schedule the same Faces program; the two must agree EXACTLY (pure Python
on both sides): node ``structural_key()`` sequences, ``stats()``,
segment plans (op ids normalized to program positions), host dispatch
counts and the simulated derived cost.
"""
import pytest

pytest.importorskip("torch")

from repro.core import host_dispatch_count as ref_dispatch_count
from repro.core import pattern_programs as ref_programs
from repro.core import simulate_faces as ref_simulate_faces
from repro.core import simulate_pattern as ref_simulate
from repro_torch.core import host_dispatch_count, pattern_programs
from repro_torch.core import simulate_faces, simulate_pattern
from repro_torch.core.schedule import schedule
from repro_torch.core.triggered import TriggeredProgram

N4, N8 = (4, 4, 4), (8, 8, 8)

# name -> (policy, n, schedule/build knobs)
CASES = {
    "adaptive_merged": ("adaptive", N4, dict(merged=True)),
    "adaptive_unmerged": ("adaptive", N4, dict(merged=False)),
    "static_merged": ("static", N4, dict(merged=True)),
    "static_unmerged": ("static", N4, dict(merged=False)),
    "none_merged": ("none", N4, dict(merged=True)),
    "none_unmerged": ("none", N4, dict(merged=False)),
    "application_merged": ("application", N4, dict(merged=True)),
    "application_unmerged": ("application", N4, dict(merged=False)),
    "ordered": ("adaptive", N4, dict(ordered=True)),
    "nstreams2_double_buffer": ("adaptive", N4,
                                dict(nstreams=2, double_buffer=True)),
    "rpn4_node_aware_pack": ("adaptive", N4,
                             dict(ranks_per_node=4, node_aware=True,
                                  coalesce=True, pack=True)),
    "rpn4_chunk64": ("adaptive", N8, dict(ranks_per_node=4,
                                         chunk_bytes=64)),
    "fused": ("adaptive", N4, dict(fused=True)),
    "fused_nstreams2_node_aware": ("static", N4,
                                   dict(fused=True, nstreams=2,
                                        double_buffer=True,
                                        ranks_per_node=4,
                                        node_aware=True, pack=True)),
}
NITER = 3


def _programs(fn, policy, n, knobs):
    """Programs exactly as simulate_pattern builds them for ``policy``."""
    return fn("faces", NITER, grid=(2, 2, 2), n=n,
              throttle="static" if policy == "application" else policy,
              host_sync_every=1 if policy == "application" else 0,
              resources=16, **knobs)


def _plan(prog):
    plan = prog.meta.get("segment_plan")
    if plan is None:
        return None
    pos = {n.op_id: i for i, n in enumerate(prog.nodes)}
    segs = [(s.stream, s.wave, tuple(pos[o] for o in s.op_ids),
             tuple(sorted(s.arena.items())), s.arena_nbytes)
            for s in plan.segments]
    return (segs, sorted(pos[h] for h in plan.heads),
            sorted((pos[o], w) for o, w in plan.wave_of.items()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_faces_schedule_matches_reference(case):
    policy, n, knobs = CASES[case]
    ref = _programs(ref_programs, policy, n, knobs)
    got = _programs(pattern_programs, policy, n, knobs)
    assert len(got) == len(ref) == (NITER if policy == "application"
                                    else 1)
    for g, r in zip(got, ref):
        assert g.key() == r.key()
        assert g.stats() == r.stats()
        assert _plan(g) == _plan(r)
        assert host_dispatch_count(g) == ref_dispatch_count(r)
    if knobs.get("fused"):
        assert all(p.meta["segments"] > 0 for p in got)
    if knobs.get("chunk_bytes"):
        assert got[0].stats()["chunked_puts"] > 0       # not vacuous
    if knobs.get("pack"):
        assert got[0].stats()["packed_puts"] > 0
    kw = dict(knobs, n=n, grid=(2, 2, 2), resources=16)
    for host_orchestrated in (False, True):
        assert simulate_pattern("faces", NITER, policy=policy,
                                host_orchestrated=host_orchestrated,
                                **kw) == \
            ref_simulate("faces", NITER, policy=policy,
                         host_orchestrated=host_orchestrated, **kw)


@pytest.mark.parametrize("policy", ["adaptive", "application"])
def test_simulate_faces_wrapper_matches_reference(policy):
    for merged in (True, False):
        assert simulate_faces(4, (8, 8, 8), policy=policy, merged=merged) \
            == ref_simulate_faces(4, (8, 8, 8), policy=policy,
                                  merged=merged)


def test_verify_and_tuner_are_not_ported_yet():
    """The verifier is ported (``schedule(verify=True)`` runs it: an
    empty program verifies clean; tests/test_torch_verify.py holds it to
    the reference's), and so is the tuner (tests/test_torch_autotune.py);
    the calibrated cost model the JAX package's tuner can price with
    (``core/calibrate.py``) is not."""
    prog = schedule(TriggeredProgram(), verify=True)
    assert prog.nodes == [] and prog.meta["fused"] is False
    with pytest.raises(NotImplementedError, match="item 3"):
        simulate_pattern("faces", 1, cm="calibrated")
