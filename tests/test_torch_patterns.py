"""The broadcast, ring and expert-parallel a2a transports against the JAX
package's, on the CPU.

  * the registry: the port's ``available_patterns()`` equals the
    reference's five;
  * device-free parity (pure Python on both sides, so exact): for every
    case below, each under adaptive, static and no throttle, merged and
    unmerged, plain and ``fused=True``, the two packages lower and
    schedule the same program to equal node ``structural_key()``
    sequences, ``stats()``, segment plans, host dispatch counts and
    simulated derived costs (ST and host-orchestrated);
  * against the reference's multi-device runs: ONE subprocess runs the
    reference's broadcast (2, 4), ring (4) and a2a (4) programs on 8 fake
    CPU devices through ``run_compiled`` and ``run_host`` from seeded
    numpy state and saves every state key; the port, from the same state,
    must match: counters bit for bit, ring and a2a within the reference's
    own 1e-5 and 1e-4 (``tests/test_ring_a2a.py``), the broadcast's
    float32 SUMMA accumulator within 2e-5 relative (the two frameworks'
    float32 matmuls sum in other orders).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import available_patterns as ref_available
from repro.core import host_dispatch_count as ref_dispatch_count
from repro.core import pattern_programs as ref_programs
from repro.core import simulate_pattern as ref_simulate
from repro_torch.core import (STStream, available_patterns, get_pattern,
                              host_dispatch_count, pattern_programs,
                              simulate_pattern, state_from_numpy,
                              state_to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NITER = 2

# name -> (pattern, grid, build kwargs, schedule knobs)
CASES = {
    "broadcast_mc": ("broadcast", (2, 4), dict(tile=4, multicast=True), {}),
    "broadcast_uni": ("broadcast", (2, 4), dict(tile=4, multicast=False),
                      {}),
    "broadcast_mc_db": ("broadcast", (2, 4), dict(tile=4, multicast=True),
                        dict(double_buffer=True, nstreams=2)),
    "broadcast_uni_db": ("broadcast", (2, 4),
                         dict(tile=4, multicast=False),
                         dict(double_buffer=True, nstreams=2)),
    "broadcast_mc_rpn2_chunk": ("broadcast", (2, 4),
                                dict(tile=4, multicast=True),
                                dict(ranks_per_node=2, node_aware=True,
                                     chunk_bytes=32)),
    "ring": ("ring", (4,), {}, {}),
    "ring_db": ("ring", (4,), {}, dict(double_buffer=True, nstreams=2)),
    "ring_rpn2_pack": ("ring", (4,), {},
                       dict(ranks_per_node=2, node_aware=True, pack=True)),
    "ring_rpn2_chunk": ("ring", (4,), {},
                        dict(ranks_per_node=2, chunk_bytes=128)),
    "a2a": ("a2a", (4,), {}, {}),
    "a2a_db": ("a2a", (4,), {}, dict(double_buffer=True, nstreams=2)),
    "a2a_rpn2_pack": ("a2a", (4,), {},
                      dict(ranks_per_node=2, node_aware=True, pack=True)),
}


def test_available_patterns_equal_the_reference():
    assert available_patterns() == ref_available() == \
        ["a2a", "broadcast", "faces", "ring", "serve"]
    for name in ("broadcast", "ring", "a2a"):
        assert get_pattern(name).default_grid == \
            {"broadcast": (2, 4), "ring": (4,), "a2a": (2,)}[name]


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


@pytest.mark.parametrize("merged", [True, False], ids=["merged", "unmerged"])
@pytest.mark.parametrize("throttle", ["adaptive", "static", "none"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_matches_reference(case, throttle, merged):
    name, grid, build, knobs = CASES[case]
    for fused in (False, True):
        kw = dict(build, **knobs, grid=grid, throttle=throttle,
                  resources=4, merged=merged, fused=fused)
        ref = ref_programs(name, NITER, **kw)
        got = pattern_programs(name, NITER, **kw)
        assert len(got) == len(ref) == 1
        g, r = got[0], ref[0]
        assert [n.structural_key() for n in g.nodes] == \
            [n.structural_key() for n in r.nodes]
        assert g.key() == r.key()
        assert g.stats() == r.stats()
        assert _plan(g) == _plan(r)
        assert host_dispatch_count(g) == ref_dispatch_count(r)
        assert (_plan(g) is not None) == fused
    stats = g.stats()
    if knobs.get("chunk_bytes"):
        assert stats["chunked_puts"] > 0                 # not vacuous
    if knobs.get("pack"):
        assert stats["packed_puts"] > 0
    if build.get("multicast"):
        assert stats["multicast_puts"] > 0
    sim = dict(build, **knobs, grid=grid, resources=4, merged=merged)
    for host_orchestrated in (False, True):
        assert simulate_pattern(name, NITER, policy=throttle,
                                host_orchestrated=host_orchestrated,
                                **sim) == \
            ref_simulate(name, NITER, policy=throttle,
                         host_orchestrated=host_orchestrated, **sim)


# ---------------------------------------------------------------------------
# against the reference's multi-device runs (one subprocess, 8 fake
# CPU devices)
# ---------------------------------------------------------------------------

# name -> (pattern, grid, axes, niter, build kwargs, seeded buffers, sync)
REF_RUNS = {
    **{f"broadcast_{mc}_{mode}": (
        "broadcast", (2, 4), ("row", "col"), 2,
        dict(tile=8, multicast=mc == "mc"), ["abase", "b"], dict(mode=mode))
       for mc in ("mc", "uni") for mode in ("st", "host")},
    **{f"ring_{mode}": (
        "ring", (4,), ("data",), 1,
        dict(batch=1, seq_per_rank=8, heads=2, head_dim=8),
        ["q", "k", "v"], dict(mode=mode)) for mode in ("st", "host")},
    **{f"a2a_{mode}": (
        "a2a", (4,), ("model",), 1,
        dict(batch=1, seq=8, d_model=16, expert_ff=16, experts=8, top_k=2),
        ["x", "router", "wg", "wu", "wd"], dict(mode=mode))
       for mode in ("st", "host")},
}
# buffers every rank holds the same value of (the a2a tokens and router
# are replicated over the expert shards)
REPLICATED = ("x", "router")

JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax
    from repro.core import STStream, get_pattern
    from repro.launch.mesh import make_mesh

    runs = json.loads(sys.argv[1])
    init = np.load(sys.argv[2])
    saved = {}
    for name, (pat, grid, axes, niter, build, _, sync) in runs.items():
        mesh = make_mesh(tuple(grid), tuple(axes))
        stream = STStream(mesh, tuple(axes))
        get_pattern(pat).build(stream, niter, **build)
        state = {k: jax.device_put(init[name + "/" + k], v.sharding)
                 for k, v in stream.allocate().items()}
        out = stream.synchronize(state, donate=False, resources=16, **sync)
        saved.update({name + "/" + k: np.asarray(v)
                      for k, v in out.items()})
    np.savez(sys.argv[3], **saved)
""")


def _port_stream(name):
    pat, grid, axes, niter, build, _, _ = REF_RUNS[name]
    stream = STStream("cpu", axes, grid_shape=grid)
    get_pattern(pat).build(stream, niter, **build)
    return stream


def _initial_state(name):
    """Seeded numpy state: the seeded buffers uniform in [0, 0.3) (the
    replicated ones equal on every rank), the rest zero."""
    stream = _port_stream(name)
    seeds = REF_RUNS[name][5]
    rng = np.random.RandomState(0)
    out = {}
    for k, (shape, dtype) in sorted(stream.state_specs().items()):
        base = k.split(".", 1)[1]
        if base in seeds:
            per = shape[1:] if base in REPLICATED else shape
            val = (rng.rand(*per) * 0.3).astype(dtype)
            out[k] = np.broadcast_to(val, shape).copy()
        else:
            out[k] = np.zeros(shape, dtype)
    return out


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("transports_ref")
    init = {f"{name}/{k}": v for name in REF_RUNS
            for k, v in _initial_state(name).items()}
    np.savez(d / "init.npz", **init)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, json.dumps(REF_RUNS),
         str(d / "init.npz"), str(d / "ref.npz")],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return np.load(d / "init.npz"), np.load(d / "ref.npz")


def _tolerance(name, key):
    """(rtol, atol) of a state key, or None where it must be exact."""
    if key.endswith("_sig") or key.endswith("_sig__pp") or \
            key.endswith((".it", ".step")):
        return None
    if name.startswith("broadcast"):
        return (2e-5, 0.0)
    return (0.0, 1e-5 if name.startswith("ring") else 1e-4)


@pytest.mark.parametrize("name", sorted(REF_RUNS))
def test_port_matches_jax_reference(jax_reference, name):
    init, ref = jax_reference
    stream = _port_stream(name)
    state = state_from_numpy(stream, {k: init[f"{name}/{k}"]
                                      for k in stream.state_specs()})
    out = state_to_numpy(stream.synchronize(state, resources=16,
                                            **REF_RUNS[name][6]))
    assert {f"{name}/{k}" for k in out} == \
        {k for k in ref.files if k.startswith(name + "/")}
    for k, got in out.items():
        want = ref[f"{name}/{k}"]
        assert got.shape == want.shape and got.dtype == want.dtype, k
        tol = _tolerance(name, k)
        if tol is None:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1],
                                       err_msg=k)
    result = {"broadcast": "bcast.ctile", "ring": "ring.out",
              "a2a": "a2a.out"}[REF_RUNS[name][0]]
    assert np.abs(out[result]).max() > 0, "vacuous"
    counters = [k for k in out if k.endswith("_sig")]
    assert counters and all(out[k].any() for k in counters)
