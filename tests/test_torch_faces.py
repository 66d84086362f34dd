"""Faces through the port's executors on the CPU.

Two parts:

  * in process: the port's ST x {adaptive, static, none} x {merged,
    unmerged}, host x {merged, unmerged} and fused runs against a numpy
    replay of Faces (the oracle of ``scripts/dev_faces.py``, same
    tolerances), with every counter slot equal to the iteration count,
    plus the executors' dispatch accounting and input immutability;
  * against the JAX package: ONE subprocess runs the reference on 8 fake
    CPU devices for the configs in ``REF_CONFIGS`` from seeded numpy
    state and saves every state key; the port, started from the same
    state through ``state_from_numpy``, must equal it EXACTLY on every
    key.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (STStream, counters_expected, halo,
                              host_dispatch_count, state_from_numpy,
                              state_to_numpy)
from repro_torch.core.backends import run_host
from repro_torch.core.triggered import TriggeredOp, TriggeredProgram

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("x", "y", "z")
GRID, N, NITER = (2, 2, 2), (4, 4, 4), 3


def numpy_oracle(src0):
    """src0: (8, nx,ny,nz) initial blocks. Replays NITER iterations."""
    px, py, pz = GRID
    src = src0.copy()
    acc = None
    for it in range(NITER):
        src = src + np.float32(1.0 + it % 3)
        acc = np.zeros_like(src)
        for d in halo.DIRECTIONS:
            for x in range(px):
                for y in range(py):
                    for z in range(pz):
                        srank = (x * py + y) * pz + z
                        tx, ty, tz = ((x + d[0]) % px, (y + d[1]) % py,
                                      (z + d[2]) % pz)
                        trank = (tx * py + ty) * pz + tz
                        sl = halo.surface_slices(N, d)
                        acc[(trank,) + sl] += src[(srank,) + sl]
    return src, acc


@pytest.fixture(scope="module")
def oracle():
    src0 = np.random.RandomState(0).rand(8, *N).astype(np.float32)
    return src0, numpy_oracle(src0)


def _run(mode, src0, *, merged=True, throttle="adaptive", **sync):
    stream = STStream("cpu", AXES, grid_shape=GRID)
    halo.build_faces_program(stream, N, NITER, merged=merged)
    state = stream.allocate()
    state["faces.src"] = torch.from_numpy(src0.copy())
    out = stream.synchronize(state, mode=mode, throttle=throttle,
                             resources=16, merged=merged, **sync)
    return stream, state, out


ORACLE_CASES = ([("st", thr, merged) for merged in (True, False)
                 for thr in ("adaptive", "static", "none")]
                + [("host", "adaptive", True), ("host", "adaptive", False),
                   ("fused", "adaptive", True)])


@pytest.mark.parametrize("mode,throttle,merged", ORACLE_CASES)
def test_faces_matches_numpy_oracle(oracle, mode, throttle, merged):
    src0, (src_exp, acc_exp) = oracle
    _, _, out = _run(mode, src0, merged=merged, throttle=throttle)
    np.testing.assert_allclose(out["faces.src"].numpy(), src_exp, rtol=1e-6)
    np.testing.assert_allclose(out["faces.acc"].numpy(), acc_exp, rtol=1e-5)
    for c in ("faces.post_sig", "faces.comp_sig"):
        for row in out[c].numpy():
            np.testing.assert_array_equal(row, counters_expected(NITER, 26))
    np.testing.assert_array_equal(
        out["faces.res"].numpy()[:, 0],
        np.abs(out["faces.acc"].numpy()).reshape(8, -1).max(axis=1))


def test_executors_bit_identical_and_inputs_untouched(oracle):
    src0, _ = oracle
    outs = {}
    for mode, merged in [("st", True), ("host", True), ("fused", True),
                         ("st", False), ("host", False)]:
        _, state, out = _run(mode, src0, merged=merged)
        np.testing.assert_array_equal(state["faces.src"].numpy(), src0)
        assert not any(v.any() for k, v in state.items()
                       if k != "faces.src")
        outs[(mode, merged)] = out
    for key, out in outs.items():
        for k, v in out.items():
            assert torch.equal(v, outs[("st", True)][k]), (key, k)


@pytest.mark.parametrize("mode,merged", [("st", True), ("host", True),
                                         ("host", False), ("fused", True)])
def test_dispatch_units(oracle, mode, merged):
    """st issues one unit per descriptor, host adds one per separately
    dispatched wire completion signal, fused one per planned segment —
    exactly the simulator's host_dispatch_count for fused programs."""
    src0, _ = oracle
    stream, _, _ = _run(mode, src0, merged=merged, nstreams=2)
    progs = stream.scheduled_programs(resources=16, merged=merged,
                                      nstreams=2, fused=mode == "fused")
    nodes = sum(len(p.nodes) for p in progs)
    wire = sum(1 for p in progs for n in p.puts()
               if n.chained is not None and n.chained.wire)
    want = {"st": nodes, "host": nodes + wire,
            "fused": sum(host_dispatch_count(p) for p in progs)}[mode]
    assert stream.dispatches == want
    if mode == "fused":
        assert 1 < stream.dispatches < nodes


@pytest.mark.parametrize("mode", ["st", "host", "fused"])
@pytest.mark.parametrize("sched", [
    dict(pack=True, node_aware=True, coalesce=True),
    dict(chunk_bytes=32),
    dict(pack=True, chunk_bytes=32),
    dict(nstreams=2, ordered=True),
], ids=["pack", "chunk", "pack_chunk", "nstreams2_ordered"])
def test_transport_schedules_bit_identical(oracle, mode, sched):
    """Packed, chunked and reordered put descriptors move the same bytes:
    every data buffer equals the plain single-stream ST run exactly (two
    nodes of four ranks, so the off-node puts pack and chunk). Counters
    legitimately differ — a packed descriptor lands ONE completion for
    its group — and are held against the JAX package below."""
    src0, _ = oracle
    outs = []
    for kw in (dict(mode="st"), dict(sched, mode=mode)):
        stream = STStream("cpu", AXES, grid_shape=GRID)
        halo.build_faces_program(stream, N, NITER, ranks_per_node=4)
        state = stream.allocate()
        state["faces.src"] = torch.from_numpy(src0.copy())
        outs.append(stream.synchronize(state, resources=16, **kw))
        prog = stream.scheduled_programs(
            resources=16, fused=mode == "fused",
            **{k: v for k, v in kw.items() if k != "mode"})[0]
    stats = prog.stats()
    assert stats["packed_puts"] or stats["chunked_puts"] or \
        stats["nstreams"] == 2                          # not vacuous
    for k, v in outs[0].items():
        if not k.endswith("_sig"):
            assert torch.equal(outs[1][k], v), k


def test_run_host_rejects_forward_edge():
    stream = STStream("cpu", AXES, grid_shape=GRID)
    a, b = TriggeredOp("complete"), TriggeredOp("complete")
    a.deps = (b.op_id,)
    with pytest.raises(ValueError, match="out of dispatch order"):
        run_host(stream, TriggeredProgram(nodes=[a, b]), {})


def test_state_numpy_round_trip_and_checks():
    stream = STStream("cpu", AXES, grid_shape=GRID)
    halo.create_faces_window(stream, N)
    arrays = {k: np.full(shape, 2, dtype)
              for k, (shape, dtype) in stream.state_specs().items()}
    back = state_to_numpy(state_from_numpy(stream, arrays))
    assert back.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
        assert back[k].dtype == arrays[k].dtype
    with pytest.raises(ValueError, match="keys differ"):
        state_from_numpy(stream, {k: v for k, v in arrays.items()
                                  if k != "faces.src"})
    bad = dict(arrays, **{"faces.src": arrays["faces.src"][:, :2]})
    with pytest.raises(ValueError, match="faces.src"):
        state_from_numpy(stream, bad)
    bad = dict(arrays, **{"faces.post_sig":
                          arrays["faces.post_sig"].astype(np.int64)})
    with pytest.raises(ValueError, match="post_sig"):
        state_from_numpy(stream, bad)


# ---------------------------------------------------------------------------
# bit-identity with the JAX package (one subprocess, 8 fake CPU devices)
# ---------------------------------------------------------------------------

REF_N, REF_NITER = (4, 3, 5), 2


def _cfg(mode, merged=True, periodic=True, double_buffer=False,
         ranks_per_node=None, **sync):
    return {"periodic": periodic,
            "build": dict(merged=merged, double_buffer=double_buffer,
                          ranks_per_node=ranks_per_node),
            "sync": dict(mode=mode, merged=merged, resources=16, **sync)}


# The JAX host executor compiles one executable per distinct descriptor:
# unmerged host mode needs ~140 of them (~45 s), so it is held here
# through its bit-identity with the port's unmerged ST run
# (test_executors_bit_identical_and_inputs_untouched), which is.
REF_CONFIGS = {
    "st_adaptive": _cfg("st", throttle="adaptive"),
    "st_static": _cfg("st", throttle="static"),
    "st_unmerged": _cfg("st", merged=False),
    "host_merged": _cfg("host"),
    "fused": _cfg("fused"),
    "st_nstreams2_double_buffer": _cfg("st", double_buffer=True,
                                       nstreams=2),
    "st_nonperiodic": _cfg("st", periodic=False),
    "st_rpn4_pack_chunk": _cfg("st", ranks_per_node=4, pack=True,
                               node_aware=True, chunk_bytes=32),
}

JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax
    from repro.core import STStream, halo
    from repro.launch.mesh import make_mesh

    configs = json.loads(sys.argv[1])
    n, niter = tuple(json.loads(sys.argv[2])), int(sys.argv[3])
    init = np.load(sys.argv[4])
    mesh = make_mesh((2, 2, 2), ("x", "y", "z"))
    saved = {}
    for name, cfg in configs.items():
        stream = STStream(mesh, ("x", "y", "z"), periodic=cfg["periodic"])
        halo.build_faces_program(stream, n, niter, **cfg["build"])
        state = {k: jax.device_put(init[name + "/" + k], v.sharding)
                 for k, v in stream.allocate().items()}
        out = stream.synchronize(state, donate=False, **cfg["sync"])
        saved.update({name + "/" + k: np.asarray(v)
                      for k, v in out.items()})
    np.savez(sys.argv[5], **saved)
""")


def _port_stream(cfg):
    stream = STStream("cpu", AXES, periodic=cfg["periodic"],
                      grid_shape=GRID)
    halo.build_faces_program(stream, REF_N, REF_NITER, **cfg["build"])
    return stream


def _initial_state(stream):
    """Seeded numpy state: every float buffer random except the
    iteration counter, counters zero."""
    rng = np.random.RandomState(0)
    out = {}
    for k, (shape, dtype) in sorted(stream.state_specs().items()):
        if dtype == "float32" and not k.endswith(".it"):
            out[k] = rng.rand(*shape).astype(np.float32)
        else:
            out[k] = np.zeros(shape, dtype)
    return out


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("faces_ref")
    init = {}
    for name, cfg in REF_CONFIGS.items():
        for k, v in _initial_state(_port_stream(cfg)).items():
            init[f"{name}/{k}"] = v
    np.savez(d / "init.npz", **init)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, json.dumps(REF_CONFIGS),
         json.dumps(REF_N), str(REF_NITER), str(d / "init.npz"),
         str(d / "ref.npz")],
        env=env, capture_output=True, text=True, timeout=90)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return np.load(d / "init.npz"), np.load(d / "ref.npz")


@pytest.mark.parametrize("name", sorted(REF_CONFIGS))
def test_port_bit_identical_to_jax_reference(jax_reference, name):
    init, ref = jax_reference
    cfg = REF_CONFIGS[name]
    stream = _port_stream(cfg)
    state = state_from_numpy(stream, {k: init[f"{name}/{k}"]
                                      for k in stream.state_specs()})
    out = state_to_numpy(stream.synchronize(state, **cfg["sync"]))
    assert {f"{name}/{k}" for k in out} == \
        {k for k in ref.files if k.startswith(name + "/")}
    for k, got in out.items():
        want = ref[f"{name}/{k}"]
        if k.endswith(".res"):
            # the JAX compare kernels return (1,) per rank, which
            # shard_map concatenates to (R,); the port keeps the
            # window's (R, 1) — same values, same order
            assert got.shape == (want.shape[0], 1)
            got = got[:, 0]
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert np.asarray(out["faces.acc"]).any(), "vacuous"
