"""The put that carries its completion signal, and the unpack that takes
the per-rank max in the same pass, on the CPU.

Their plain versions (what the wrappers run for a CPU tensor) must equal
what the port emitted before either existed: a permuted copy
(``index_select``, or ``index_copy_`` into zeros where a rank has no
source) followed by a counter bump ``sig + upd``, and the unpack
followed by a max|acc| pass. The emission must call the signal-carrying
put once per put and the standalone bump once per post signal in st and
fused mode, and the bump once more per put in host mode. The CUDA
kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import STStream, halo
from repro_torch.core import engine
from repro_torch.core.halo import DIRECTIONS, _max_abs
from repro_torch.kernels import _build
from repro_torch.kernels.counter_bump import (counter_bump, put_signal,
                                              put_signal_ref)
from repro_torch.kernels.halo_pack import (halo_pack_split, halo_unpack,
                                           halo_unpack_split)
from repro_torch.kernels.halo_pack import ref as href

AXES, GRID, N, NITER = ("x", "y", "z"), (2, 2, 2), (4, 3, 5), 2


def _today_ppermute(stream, x, direction):
    """The permuted copy as the port emitted it before ``put_signal``."""
    pairs = stream.perm_for(tuple(direction))
    if len(pairs) == stream.num_ranks:
        idx = np.empty((stream.num_ranks,), np.int64)
        for src, dst in pairs:
            idx[dst] = src
        return x.index_select(0, torch.as_tensor(idx))
    src = torch.as_tensor([p[0] for p in pairs], dtype=torch.int64)
    dst = torch.as_tensor([p[1] for p in pairs], dtype=torch.int64)
    out = torch.zeros_like(x)
    out.index_copy_(0, dst, x.index_select(0, src))
    return out


def _payload(rng, shape, dtype):
    if dtype == torch.int32:
        return torch.from_numpy(rng.randint(-2**31, 2**31 - 1, shape,
                                            dtype=np.int64)).to(dtype)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32], ids=str)
@pytest.mark.parametrize("periodic", [True, False])
def test_put_signal_ref_equals_ppermute_and_bump(rng, periodic, dtype):
    stream = STStream("cpu", AXES, periodic=periodic, grid_shape=GRID)
    R = stream.num_ranks
    sig = torch.from_numpy(rng.randint(0, 1000, (R, 26)).astype(np.int32))
    scattered = 0
    for k, d in enumerate(DIRECTIONS):
        x = _payload(rng, (R, 3, 5), dtype)
        perm = engine._perm_index(stream, d)
        scattered += bool((perm < 0).any())
        want = _today_ppermute(stream, x, d)
        # one branch, and a multi-branch update (a merged or multicast
        # completion: several slots, each its direction's arrival mask)
        for slots in (((k, d),), ((k, d), ((k + 5) % 26, DIRECTIONS[0]),
                                  ((k + 9) % 26, DIRECTIONS[-1]))):
            upd = engine._counter_update(stream, slots, 26)
            for fn in (put_signal, put_signal_ref):
                got, cnt = fn(x, perm, sig, upd)
                assert got.dtype == dtype and torch.equal(got, want)
                assert torch.equal(cnt, engine._bump(stream, sig, slots))
            assert torch.equal(put_signal(x, perm), want)
    # the non-periodic grid has ranks with no source in most directions
    assert bool(scattered) == (not periodic)


def test_put_signal_takes_rank_strided_rows(rng):
    """A chunk of a pipelined put is a column slice of its payload: each
    rank's elements contiguous, the ranks at the parent's stride."""
    x = _payload(rng, (8, 40), torch.float32)
    perm = torch.tensor([3, -1, 0, 7, 7, -1, 1, 2])
    view = x[:, 5:29]
    got = put_signal(view, perm)
    assert got.is_contiguous() and got.shape == view.shape
    want = torch.zeros_like(view)
    for dst, src in enumerate(perm.tolist()):
        if src >= 0:
            want[dst] = view[src]
    assert torch.equal(got, want)


def test_put_signal_rejects_bad_inputs():
    x = torch.zeros(4, 6)
    perm = torch.arange(4)
    sig = torch.zeros(4, 26, dtype=torch.int32)
    with pytest.raises(ValueError, match="perm"):
        put_signal(x, perm[:3])                          # wrong length
    with pytest.raises(ValueError, match="perm"):
        put_signal(x, perm.to(torch.int32))              # not int64
    with pytest.raises(ValueError, match="together"):
        put_signal(x, perm, sig)                         # no update
    with pytest.raises(TypeError):
        put_signal(x, perm, sig, sig.float())            # not int32
    with pytest.raises(ValueError):
        put_signal(x, perm, sig, sig[:, :3])             # shapes differ


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("n", [(4, 4, 4), (6, 5, 3), (1, 3, 2)])
def test_unpack_with_max_equals_unpack_then_max(rng, n, nan):
    f = torch.from_numpy(rng.standard_normal((3,) + n).astype(np.float32))
    recvs = [p.clone() for p in halo_pack_split(f)]
    if nan:
        recvs[4][1, 0] = float("nan")        # one surface, one rank
    acc, res = halo_unpack_split(recvs, n, with_max=True)
    want = href.halo_unpack_split_ref(recvs, n)
    torch.testing.assert_close(acc, want, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(res, _max_abs(want), rtol=0, atol=0,
                               equal_nan=True)
    assert res.shape == (3, 1) and bool(res[1].isnan()) == nan
    flat = torch.cat(recvs, dim=1)
    acc2, res2 = halo_unpack(flat, n, with_max=True)
    torch.testing.assert_close(acc2, acc, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(res2, res, rtol=0, atol=0, equal_nan=True)
    # without the max, the wrappers return the accumulator alone
    torch.testing.assert_close(halo_unpack_split(recvs, n), acc, rtol=0,
                               atol=0, equal_nan=True)


def test_faces_unpack_compare_is_unpack_and_max(rng):
    kernels = halo.make_faces_kernels(N)
    src = torch.from_numpy(rng.standard_normal((8,) + N).astype(np.float32))
    recvs = halo_pack_split(src)
    acc, res = kernels["unpack_compare"](src, *recvs)
    want = href.halo_unpack_split_ref(recvs, N)
    assert torch.equal(acc, want) and torch.equal(res, _max_abs(want))
    assert torch.equal(kernels["compare"](acc), res)


def _counted(monkeypatch):
    calls = {"put_signal": 0, "put_signal+sig": 0, "counter_bump": 0}

    def put(x, perm, sig=None, upd=None):
        calls["put_signal" if sig is None else "put_signal+sig"] += 1
        return put_signal(x, perm, sig, upd)

    def bump(sig, upd):
        calls["counter_bump"] += 1
        return counter_bump(sig, upd)
    monkeypatch.setattr(engine, "put_signal", put)
    monkeypatch.setattr(engine, "counter_bump", bump)
    return calls


SCHED = dict(pack=True, node_aware=True, chunk_bytes=32)


@pytest.mark.parametrize("mode,merged,sched", [
    ("st", True, {}), ("fused", True, {}), ("host", True, {}),
    ("st", False, {}), ("host", False, {}),
    ("st", True, SCHED), ("fused", True, SCHED), ("host", True, SCHED)],
    ids=lambda v: "pack_chunk" if v == SCHED else None)
def test_emission_puts_carry_their_signal(monkeypatch, mode, merged, sched):
    """st and fused: one signal-carrying put per put descriptor and one
    standalone bump per post signal; host: the put without its signal and
    one more bump per put (its completion)."""
    calls = _counted(monkeypatch)
    stream = STStream("cpu", AXES, grid_shape=GRID)
    halo.build_faces_program(stream, N, NITER, merged=merged,
                             ranks_per_node=4 if sched else None)
    state = stream.allocate()
    stream.synchronize(state, mode=mode, merged=merged, resources=16,
                       **sched)
    progs = stream.scheduled_programs(resources=16, merged=merged,
                                      fused=mode == "fused", **sched)
    puts = sum(1 for p in progs for n in p.nodes if n.kind == "put")
    posts = sum(1 for p in progs for n in p.nodes
                if n.kind == "signal" and n.role == "post")
    assert all(n.chained is not None for p in progs for n in p.puts())
    if sched:
        assert progs[0].stats()["packed_puts"]               # not vacuous
    else:
        assert puts == 26 * NITER
        assert posts == NITER * (1 if merged else 26)
    if mode == "host":
        assert calls == {"put_signal": puts, "put_signal+sig": 0,
                         "counter_bump": posts + puts}
    else:
        assert calls == {"put_signal": 0, "put_signal+sig": puts,
                         "counter_bump": posts}


def test_cpu_faces_launches_no_kernel():
    _build.reset_launches()
    stream = STStream("cpu", AXES, periodic=False, grid_shape=GRID)
    halo.build_faces_program(stream, N, 1)
    stream.synchronize(stream.allocate(), mode="st")
    assert set(_build.LAUNCHES.values()) == {0}
