"""The multicast put that carries its completion signal, on the CPU.

  * its plain version (what the wrapper runs for a CPU tensor) equals one
    ``put_signal_ref`` per branch plus the bump ``sig + upd``, on the
    broadcast's branch tables (periodic and not: -1 entries) and on
    hand-made tables with repeated sources, in float32, bf16, int32 and
    uint8;
  * the card's wrapper, with the launch faked and the device check
    bypassed (meta tensors, no card): one launch per call with the
    payload's row bytes, rank stride, rank and branch counts, any 1-, 2-,
    4- or 8-byte dtype, ``nb`` landing buffers shaped like the payload,
    and its refusals;
  * the emission: in st and fused mode one ``put_multicast`` with its
    signal per multicast descriptor (chunks included) and one standalone
    bump per post signal; in host mode the multicast without its signal
    and one more bump per multicast (its completion tree). The kernel
    itself is held against the plain version on the card
    (``tests/test_torch_cuda.py``).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import STStream, engine
from repro_torch.core.broadcast import build_broadcast_program
from repro_torch.kernels import _build
from repro_torch.kernels.counter_bump import (counter_bump, put_multicast,
                                              put_multicast_ref, put_signal,
                                              put_signal_ref)
from repro_torch.kernels.counter_bump import ops

DIRS = [(0, 1), (0, 2), (0, 3)]


def _payload(rng, shape, dtype):
    if dtype in (torch.int32, torch.uint8):
        hi = 2**31 - 1 if dtype == torch.int32 else 255
        return torch.from_numpy(rng.randint(0, hi, shape, dtype=np.int64)
                                ).to(dtype)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8], ids=str)
@pytest.mark.parametrize("periodic", [True, False])
def test_plain_version_is_put_signal_per_branch_and_a_bump(rng, periodic,
                                                            dtype):
    stream = STStream("cpu", ("row", "col"), periodic=periodic,
                      grid_shape=(2, 4))
    R = stream.num_ranks
    perms = engine._mcast_index(stream, DIRS)
    assert perms.shape == (3, R) and perms.dtype == torch.int64
    assert bool((perms < 0).any()) == (not periodic)
    slots = tuple((2 - k, d) for k, d in enumerate(DIRS))
    upd = engine._counter_update(stream, slots, 3)
    sig = torch.from_numpy(rng.randint(0, 100, (R, 3)).astype(np.int32))
    x = _payload(rng, (R, 3, 5), dtype)
    for fn in (put_multicast, put_multicast_ref):
        outs, cnt = fn(x, perms, sig, upd)
        assert len(outs) == 3
        for b, d in enumerate(DIRS):
            want = put_signal_ref(x, engine._perm_index(stream, d))
            assert outs[b].dtype == dtype and torch.equal(outs[b], want)
        assert torch.equal(cnt, counter_bump(sig, upd))
        assert torch.equal(cnt, engine._bump(stream, sig, slots))
        assert all(torch.equal(a, b) for a, b in zip(fn(x, perms), outs))


def test_plain_version_takes_repeated_sources_and_rank_strided_rows(rng):
    x = _payload(rng, (6, 40), torch.float32)[:, 3:27]
    perms = torch.tensor([[3, -1, 0, 5, 5, -1], [-1, -1, -1, -1, -1, -1],
                          [0, 1, 2, 3, 4, 5]])
    outs = put_multicast(x, perms)
    for b in range(3):
        assert outs[b].is_contiguous()
        assert torch.equal(outs[b], put_signal(x, perms[b]))
    assert not outs[1].any()


class _FakeLaunch:
    """The kernel library as the wrapper calls it: records each launch's
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def put_multicast_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLaunch()
    monkeypatch.setattr(ops, "_check_launch", lambda *a, **k: None)
    monkeypatch.setattr(ops._build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    _build.reset_launches()
    yield lib
    _build.reset_launches()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8, torch.float64,
                                   torch.int8], ids=str)
def test_card_wrapper_takes_any_element_size(fake, dtype):
    R, nb = 8, 3
    x = torch.zeros((R, 4, 5), dtype=dtype, device="meta")
    perms = torch.zeros((nb, R), dtype=torch.int64, device="meta")
    sig = torch.zeros((R, nb), dtype=torch.int32, device="meta")
    outs = put_multicast(x, perms)
    assert len(outs) == nb
    assert all(o.shape == x.shape and o.dtype == dtype and o.is_contiguous()
               for o in outs)
    outs, cnt = put_multicast(x, perms, sig, sig)
    assert cnt.shape == sig.shape and cnt.dtype == torch.int32
    row = 20 * x.element_size()
    # (x, rank stride bytes, out, row bytes, R, nb, perms, sig, upd,
    #  sig out, signal slots, stream)
    assert [c[1] for c in fake.calls] == [row, row]
    assert [c[3:6] for c in fake.calls] == [(row, R, nb)] * 2
    assert [c[10] for c in fake.calls] == [0, R * nb]
    assert fake.calls[0][9] is None and fake.calls[1][9] is not None
    assert _build.LAUNCHES["put_multicast"] == 2
    # a column slice: ranks at the parent's stride, rows contiguous
    wide = torch.zeros((R, 40), dtype=dtype, device="meta")
    put_multicast(wide[:, 5:29], perms)
    assert fake.calls[-1][1] == 40 * x.element_size()
    assert fake.calls[-1][3] == 24 * x.element_size()


def test_card_wrapper_refusals(fake):
    R = 8
    x = torch.zeros((R, 6), device="meta")
    perms = torch.zeros((3, R), dtype=torch.int64, device="meta")
    sig = torch.zeros((R, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="perms"):
        put_multicast(x, perms[:, :5])                   # wrong R
    with pytest.raises(ValueError, match="perms"):
        put_multicast(x, perms[0])                       # not a table
    with pytest.raises(ValueError, match="perms"):
        put_multicast(x, perms[:0])                      # no branch
    with pytest.raises(ValueError, match="perms"):
        put_multicast(x, perms.to(torch.int32))
    with pytest.raises(ValueError, match="together"):
        put_multicast(x, perms, sig)
    with pytest.raises(TypeError):
        put_multicast(x, perms, sig, sig.float())
    with pytest.raises(ValueError, match="contiguous"):
        put_multicast(torch.zeros((6, R), device="meta").t(), perms)
    many = torch.zeros((64, 200), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="shared memory"):
        put_multicast(torch.zeros((200, 2), device="meta"), many)
    with pytest.raises(ValueError, match="perms on"):
        put_multicast(x, torch.zeros((3, R), dtype=torch.int64))
    assert fake.calls == [] and _build.LAUNCHES["put_multicast"] == 0


def _counted(monkeypatch):
    calls = {"put_multicast": 0, "put_multicast+sig": 0,
             "put_signal+sig": 0, "put_signal": 0, "counter_bump": 0}

    def mput(x, perms, sig=None, upd=None):
        calls["put_multicast" if sig is None else "put_multicast+sig"] += 1
        return put_multicast(x, perms, sig, upd)

    def put(x, perm, sig=None, upd=None):
        calls["put_signal" if sig is None else "put_signal+sig"] += 1
        return put_signal(x, perm, sig, upd)

    def bump(sig, upd):
        calls["counter_bump"] += 1
        return counter_bump(sig, upd)
    monkeypatch.setattr(engine, "put_multicast", mput)
    monkeypatch.setattr(engine, "put_signal", put)
    monkeypatch.setattr(engine, "counter_bump", bump)
    return calls


@pytest.mark.parametrize("sched", [{}, dict(chunk_bytes=32)],
                         ids=["plain", "chunk"])
@pytest.mark.parametrize("merged", [True, False],
                         ids=["merged", "unmerged"])
@pytest.mark.parametrize("mode", ["st", "fused", "host"])
def test_emission_multicast_is_one_launch(monkeypatch, mode, merged, sched):
    calls = _counted(monkeypatch)
    niter = 2
    stream = STStream("cpu", ("row", "col"), grid_shape=(2, 4))
    build_broadcast_program(stream, niter, tile=4,
                            ranks_per_node=2 if sched else None)
    kw = dict(resources=4, merged=merged, node_aware=bool(sched), **sched)
    stream.synchronize(stream.allocate(), mode=mode, **kw)
    prog, = stream.scheduled_programs(fused=mode == "fused", **kw)
    mputs = [n for n in prog.puts() if n.mcast_dirs]
    posts = sum(1 for n in prog.nodes
                if n.kind == "signal" and n.role == "post")
    assert len(mputs) == len(prog.puts())
    assert len(mputs) == niter * (prog.stats()["chunked_puts"] // niter
                                  if sched else 1)
    if sched:
        assert len(mputs) > niter                        # chunked
    assert posts == niter * (1 if merged else 3)
    want = {k: 0 for k in calls}
    if mode == "host":
        want.update(put_multicast=len(mputs),
                    counter_bump=posts + len(mputs))
    else:
        want.update({"put_multicast+sig": len(mputs),
                     "counter_bump": posts})
    assert calls == want


def test_cpu_broadcast_launches_no_kernel():
    _build.reset_launches()
    stream = STStream("cpu", ("row", "col"), grid_shape=(2, 4))
    build_broadcast_program(stream, 1, tile=4)
    stream.synchronize(stream.allocate(), mode="st")
    assert set(_build.LAUNCHES.values()) == {0}
