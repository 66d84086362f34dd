"""The SUMMA-style row broadcast through the port's executors on the CPU.

  * against a numpy oracle of ``spin``/``update`` and the row fanout: the
    pivot tiles, every landing buffer, the float32 accumulator (numpy's
    float32 products sum in another order: 1e-5 relative) and every
    counter slot (the iteration count, split over the ping/pong sets when
    double-buffered), multicast and unicast, in st, host and fused mode;
  * the multicast descriptor bit for bit its unicast fanout (the
    reference's own property, ``src/repro/core/broadcast.py``), in every
    mode, double-buffered on two streams, and chunked on two nodes of two
    ranks (``tests/test_chunk.py``'s case): every buffer and counter.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import STStream, counters_expected
from repro_torch.core.broadcast import build_broadcast_program

GRID, TILE, NITER = (2, 4), 4, 3
MODES = ("st", "host", "fused")


def _run(mode, *, multicast, double_buffer=False, ranks_per_node=None,
         niter=NITER, **sched):
    stream = STStream("cpu", ("row", "col"), grid_shape=GRID)
    win, _ = build_broadcast_program(stream, niter, tile=TILE,
                                     multicast=multicast,
                                     double_buffer=double_buffer,
                                     ranks_per_node=ranks_per_node)
    state = stream.allocate()
    rng = np.random.RandomState(0)
    for b in ("abase", "b"):
        state[win.qual(b)] = torch.from_numpy(
            (rng.rand(8, TILE, TILE) * 0.3).astype(np.float32))
    return stream, state, stream.synchronize(state, mode=mode,
                                             resources=4, **sched)


def _oracle(abase, b, niter):
    """(last pivot, last landing buffers {k: (8, T, T)}, ctile)."""
    rows, cols = GRID
    ctile = np.zeros_like(abase)
    for t in range(niter):
        a = abase * np.float32(1.0 + 0.25 * t)
        recv = {}
        for k in range(1, cols):
            r = np.empty_like(a)
            for row in range(rows):
                for col in range(cols):
                    r[row * cols + col] = a[row * cols + (col - k) % cols]
            recv[k] = r
        ctile = ctile + a @ b
        for k in range(1, cols):
            ctile = ctile + recv[k] @ b
    return a, recv, ctile


@pytest.mark.parametrize("double_buffer", [False, True], ids=["", "db"])
@pytest.mark.parametrize("multicast", [True, False], ids=["mc", "uni"])
@pytest.mark.parametrize("mode", MODES)
def test_broadcast_matches_numpy_oracle(mode, multicast, double_buffer):
    _, state, out = _run(mode, multicast=multicast,
                         double_buffer=double_buffer)
    a, recv, ctile = _oracle(state["bcast.abase"].numpy(),
                             state["bcast.b"].numpy(), NITER)
    last = "" if not double_buffer or NITER % 2 else "__pp"
    np.testing.assert_array_equal(out[f"bcast.a{last}"].numpy(), a)
    for k, r in recv.items():
        np.testing.assert_array_equal(out[f"bcast.recva{k}{last}"].numpy(),
                                      r)
    np.testing.assert_allclose(out["bcast.ctile"].numpy(), ctile,
                               rtol=1e-5)
    np.testing.assert_array_equal(out["bcast.it"].numpy(),
                                  np.full((8, 1), NITER, np.int32))
    sets = ({"": (NITER + 1) // 2, "__pp": NITER // 2} if double_buffer
            else {"": NITER})
    for suffix, n in sets.items():
        for c in ("post_sig", "comp_sig"):
            for row in out[f"bcast.{c}{suffix}"].numpy():
                np.testing.assert_array_equal(row, counters_expected(n, 3))
    # the state handed in is not written
    assert not state["bcast.ctile"].any()


@pytest.mark.parametrize("sched", [
    dict(), dict(double_buffer=True, nstreams=2),
    dict(ranks_per_node=2, node_aware=True, chunk_bytes=32)],
    ids=["plain", "db_nstreams2", "rpn2_chunk"])
@pytest.mark.parametrize("mode", MODES)
def test_multicast_bit_identical_to_unicast(mode, sched):
    sched = dict(sched)
    build = {k: sched.pop(k) for k in ("double_buffer", "ranks_per_node")
             if k in sched}
    outs = {}
    for mc in (True, False):
        stream, _, outs[mc] = _run(mode, multicast=mc, **build, **sched)
        stats = stream.scheduled_programs(
            resources=4, fused=mode == "fused", **sched)[0].stats()
        assert bool(stats["multicast_puts"]) == mc
        if "chunk_bytes" in sched:
            assert stats["chunked_puts"] > 0            # not vacuous
    assert outs[True].keys() == outs[False].keys()
    for k, v in outs[True].items():
        assert torch.equal(v, outs[False][k]), k
    assert outs[True]["bcast.ctile"].any()
