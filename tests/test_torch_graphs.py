"""The port's CUDA-graph bookkeeping (``repro_torch.core.graphs``) on the
CPU.

A CUDA graph needs the card, so these tests swap the capture object for a
stand-in that lives in this file only: a "capture" runs the function once
(as Python runs it once under ``torch.cuda.graph``), and a "replay" runs
it again on the same input tensors and writes the results into the
tensors the capture returned (a graph writes its outputs at the addresses
it captured). What is held here is what the graphs add around the
capture: the per-stream caches and their keys, the static inputs and the
copies out, the launch accounting, the dispatch units, and the serving
engine's decode step. Graphs on the card are held to the eager emission
in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.core import STStream, engine, graphs, halo
from repro_torch.core.backends import _emit_st
from repro_torch.core.engine import _emit_fused
from repro_torch.kernels import _build
from repro_torch.kernels.halo_pack import ops as halo_ops
from repro_torch.models import init_params, model_specs
from repro_torch.serving import Request, ServingEngine

AXES = ("x", "y", "z")
GRID, N, NITER = (2, 2, 2), (4, 3, 5), 3


class _Replay:
    def __init__(self, owner, fn, inputs, out):
        self.owner, self.fn, self.inputs, self.out = owner, fn, inputs, out

    def replay(self):
        self.owner.replays += 1
        # a replay runs no Python: the wrappers' counts stay as they were
        saved = dict(_build.LAUNCHES)
        new = self.fn(self.inputs)
        _build.LAUNCHES.update(saved)
        _write_into(self.out, new)


def _write_into(dst, src):
    if dst is src:
        return
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _write_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for a, b in zip(dst, src):
            _write_into(a, b)


class StandIn:
    """The capture object, stood in for on the CPU (see the module
    docstring)."""

    def __init__(self, fail=False):
        self.captures = 0
        self.replays = 0
        self.fail = fail

    def applies(self, device):
        return device is not None

    def pool(self):
        return object()

    def synchronize(self):
        pass

    def capture(self, fn, inputs, pool):
        self.captures += 1
        # a capture records and runs nothing: what fn writes in place
        # (a decode step's cache) is put back
        leaves = graphs._leaves(inputs)
        saved = [t.clone() for t in leaves]
        out = fn(inputs)
        for t, v in zip(leaves, saved):
            t.copy_(v)
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return _Replay(self, fn, inputs, out), out


@pytest.fixture
def stand_in(monkeypatch):
    s = StandIn()
    monkeypatch.setattr(graphs, "BACKEND", s)
    return s


@pytest.fixture
def counted(monkeypatch):
    """The Faces kernels' wrappers, counting in ``_build.LAUNCHES`` as
    they do on the card (on the CPU their plain versions count nothing)."""
    def counting(fn, name):
        def call(*args, **kw):
            _build.check(0, name)
            return fn(*args, **kw)
        return call
    monkeypatch.setattr(engine, "put_signal",
                        counting(engine.put_signal, "put_signal"))
    monkeypatch.setattr(engine, "counter_bump",
                        counting(engine.counter_bump, "counter_bump"))
    monkeypatch.setattr(halo_ops, "halo_pack_split",
                        counting(halo_ops.halo_pack_split, "halo_pack"))
    monkeypatch.setattr(halo_ops, "halo_unpack_split",
                        counting(halo_ops.halo_unpack_split, "halo_unpack"))
    monkeypatch.setattr(halo_ops, "faces_increment",
                        counting(halo_ops.faces_increment,
                                 "faces_increment"))
    _build.reset_launches()
    yield
    _build.reset_launches()


def _stream(niter=NITER, merged=True):
    stream = STStream("cpu", AXES, grid_shape=GRID)
    halo.build_faces_program(stream, N, niter, merged=merged)
    state = stream.allocate()
    state["faces.src"] = torch.from_numpy(
        np.random.RandomState(0).rand(8, *N).astype(np.float32))
    return stream, state


def _copy(state):
    return {k: v.clone() for k, v in state.items()}


def _equal(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


SYNC = {"st": dict(mode="st"), "fused": dict(mode="fused"),
        "fused-2streams": dict(mode="fused", nstreams=2)}


def _eager(stream, state, sync):
    progs = stream.scheduled_programs(
        nstreams=sync.get("nstreams", 1), fused=sync["mode"] == "fused")
    emit = _emit_fused if sync["mode"] == "fused" else _emit_st
    for prog in progs:
        state = emit(stream, prog, state)
    return state


@pytest.mark.parametrize("sync", list(SYNC))
def test_same_program_replays_without_recapture(stand_in, sync):
    sync = SYNC[sync]
    stream, state = _stream()
    prog, = stream.scheduled_programs(nstreams=sync.get("nstreams", 1),
                                      fused=sync["mode"] == "fused")
    graphs_per_run = (len(prog.meta["segment_plan"].segments)
                      if sync["mode"] == "fused" else 1)
    outs = [stream.synchronize(state, **sync) for _ in range(3)]
    assert stand_in.captures == graphs_per_run
    assert stand_in.replays == 3 * graphs_per_run
    if sync.get("nstreams") == 2:
        assert graphs_per_run > 1                      # not vacuous
    cache = (stream._fused_cache if sync["mode"] == "fused"
             else stream._compiled_cache)
    assert len(cache) == 1
    want = _eager(stream, state, sync)
    for out in outs:
        assert _equal(out, want)
    stream.clear_graphs()
    assert not stream._compiled_cache and not stream._fused_cache


def test_changed_shape_layout_dtype_or_program_recaptures(stand_in):
    stream, state = _stream()
    out = stream.synchronize(state)
    assert stand_in.captures == 1
    # another stride of the same values
    strided = dict(state)
    src = state["faces.src"]
    strided["faces.src"] = src.transpose(1, 3).contiguous().transpose(1, 3)
    assert strided["faces.src"].stride() != src.stride()
    assert _equal(stream.synchronize(strided), out)
    assert stand_in.captures == 2
    # another dtype
    wide = dict(state, **{"faces.src": src.double()})
    wide_out = stream.synchronize(wide)
    assert wide_out["faces.src"].dtype == torch.float64
    assert stand_in.captures == 3
    # another shape (the per-rank max, which the program only writes)
    shaped = dict(state, **{"faces.res": torch.zeros(8, 2)})
    assert _equal(stream.synchronize(shaped), out)
    assert stand_in.captures == 4
    # another program: the same queue scheduled without throttling
    assert _equal(stream.synchronize(state, throttle="none"),
                  _eager_throttle_none(stream, state))
    assert stand_in.captures == 5
    assert len(stream._compiled_cache) == 5
    stream.synchronize(state)
    stream.synchronize(strided)
    assert stand_in.captures == 5


def _eager_throttle_none(stream, state):
    prog, = stream.scheduled_programs(throttle="none")
    return _emit_st(stream, prog, state)


@pytest.mark.parametrize("sync", list(SYNC))
def test_state_passed_in_is_unchanged(stand_in, sync):
    stream, state = _stream()
    before = _copy(state)
    stream.synchronize(state, **SYNC[sync])
    stream.synchronize(state, **SYNC[sync])
    assert _equal(state, before)


@pytest.mark.parametrize("sync", list(SYNC))
def test_earlier_result_survives_a_later_replay(stand_in, sync):
    stream, state = _stream()
    first = stream.synchronize(state, **SYNC[sync])
    kept = _copy(first)
    other = dict(state, **{"faces.src": state["faces.src"] + 1.0})
    second = stream.synchronize(other, **SYNC[sync])
    assert _equal(first, kept)
    assert not torch.equal(second["faces.src"], first["faces.src"])
    # chaining: a result handed back in is a new input like any other
    third = stream.synchronize(first, **SYNC[sync])
    assert _equal(first, kept)
    assert _equal(third, _eager(stream, first, SYNC[sync]))


@pytest.mark.parametrize("sync", list(SYNC))
def test_launches_after_n_replays_equal_n_eager_emissions(stand_in, counted,
                                                          sync):
    sync = SYNC[sync]
    stream, state = _stream()
    _eager(stream, state, sync)
    once = dict(_build.LAUNCHES)
    assert once["halo_pack"] == NITER and once["put_signal"] == 26 * NITER
    assert once["faces_increment"] == NITER
    _build.reset_launches()
    stream.synchronize(state, **sync)
    # the first run: the warm-up's eager emission, then one replay (the
    # capture itself launches nothing)
    assert _build.LAUNCHES == {k: 2 * v for k, v in once.items()}
    _build.reset_launches()
    for _ in range(3):
        stream.synchronize(state, **sync)
    assert _build.LAUNCHES == {k: 3 * v for k, v in once.items()}


@pytest.mark.parametrize("sync", list(SYNC))
def test_dispatch_units_unchanged(stand_in, sync):
    sync = SYNC[sync]
    stream, state = _stream()
    stream.synchronize(state, **sync)
    stream.synchronize(state, **sync)
    graphed = stream.dispatches
    stand_in.applies = lambda device: False          # the eager route
    stream, state = _stream()
    stream.synchronize(state, **sync)
    stream.synchronize(state, **sync)
    assert stream.dispatches == graphed
    prog, = stream.scheduled_programs(nstreams=sync.get("nstreams", 1),
                                      fused=sync["mode"] == "fused")
    want = (len(prog.meta["segment_plan"].segments)
            if sync["mode"] == "fused" else len(prog.nodes))
    assert graphed == 2 * want


@pytest.mark.parametrize("sync", list(SYNC))
def test_keys_no_descriptor_writes_are_the_callers_own(stand_in, sync):
    """The a2a program reads its tokens, router and expert weights and
    writes none of them: a run hands back the caller's tensors for those
    keys (equal by construction) and copies out only what it wrote; a
    later replay leaves them as they were. Faces writes every key."""
    from types import SimpleNamespace

    from repro_torch.core import ep_a2a

    sync = SYNC[sync]
    cfg = SimpleNamespace(d_model=16,
                          moe=ep_a2a._tiny_moe_cfg(8, 2, 16).moe)
    rng = np.random.RandomState(0)
    params = {k: torch.from_numpy(rng.rand(*shape).astype(np.float32))
              for k, shape in (("router", (16, 8)), ("w_gate", (8, 16, 16)),
                               ("w_up", (8, 16, 16)),
                               ("w_down", (8, 16, 16)))}
    x = torch.from_numpy(rng.rand(1, 8, 16).astype(np.float32))
    stream, win, state = ep_a2a.a2a_stream(cfg, params, x, ranks=4)
    read_only = {win.qual(k) for k in ("x", "router", "wg", "wu", "wd")}
    first = stream.synchronize(state, **sync)
    assert _equal(first, _eager(stream, state, sync))
    for k in read_only:
        assert first[k] is state[k]
    cache = (stream._fused_cache if sync["mode"] == "fused"
             else stream._compiled_cache)
    g, = cache.values()
    assert set(g.written) == set(state) - read_only
    copied = g.copied_bytes()
    nbytes = {k: v.numel() * v.element_size() for k, v in state.items()}
    assert copied == {"in": sum(nbytes.values()),
                      "out": sum(nbytes[k] for k in g.written)}
    kept = _copy(first)
    stream.synchronize(dict(state, **{win.qual("x"): x[None].expand(
        4, 1, 8, 16) + 1.0}), **sync)
    assert _equal(first, kept)
    stream, state = _stream()
    stream.synchronize(state, **sync)
    g, = (stream._fused_cache if sync["mode"] == "fused"
          else stream._compiled_cache).values()
    assert set(g.written) == set(state)


def test_host_mode_stays_eager(stand_in):
    stream, state = _stream()
    out = stream.synchronize(state, mode="host")
    assert stand_in.captures == 0
    assert _equal(out, stream.synchronize(state, mode="st"))


def test_a_failed_capture_raises_naming_the_program(monkeypatch, counted):
    monkeypatch.setattr(graphs, "BACKEND", StandIn(fail=True))
    stream, state = _stream()
    with pytest.raises(RuntimeError, match="capture of the ST program"):
        stream.synchronize(state)
    # only the warm-up's launches ran; the failed capture's are not kept
    assert _build.LAUNCHES["halo_pack"] == NITER
    with pytest.raises(RuntimeError, match="capture of the fused program"):
        stream.synchronize(state, mode="fused")


TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=1,
            d_ff=128, vocab_size=256, head_dim=32)


def _serve(params, cfg):
    eng = ServingEngine(cfg, params, batch_slots=3, max_len=64,
                        device="cpu")
    rng = np.random.RandomState(1)
    reqs = [Request(prompt=rng.randint(1, cfg.vocab_size, L)
                    .astype(np.int32), max_new_tokens=m)
            for L, m in ((5, 6), (9, 4), (5, 3), (17, 7), (9, 2))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return eng, [r.out_tokens for r in reqs]


def test_engine_decode_through_the_stand_in_serves_the_eager_tokens(
        monkeypatch):
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(), **TINY)
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu", getattr(torch, cfg.compute_dtype))
    eager, want = _serve(params, cfg)
    assert not isinstance(eager._decode_sample, graphs.StepGraph)
    s = StandIn()
    monkeypatch.setattr(graphs, "BACKEND", s)
    eng, got = _serve(params, cfg)
    assert isinstance(eng._decode_sample, graphs.StepGraph)
    assert got == want
    # the first decode step ran eagerly, the second captured, every
    # decode step from the second on was a replay
    assert eng._decode_sample.captures == s.captures == 1
    assert s.replays == eng.decode_steps - 1 > 3


def test_step_graph_copies_inputs_holds_state_and_counts(monkeypatch):
    s = StandIn()
    monkeypatch.setattr(graphs, "BACKEND", s)
    held = {"acc": torch.zeros(3)}

    def step(w, batch, cache):
        _build.check(0, "wkv6")
        cache["acc"].add_(batch["x"] * w)
        return cache["acc"].sum(), cache

    g = graphs.StepGraph(step, "a test step", copied=(1,))
    w = torch.full((3,), 2.0)
    _build.reset_launches()
    sums = []
    for i in range(4):
        total, cache = g(w, {"x": torch.full((3,), float(i))}, held)
        assert cache is held
        sums.append(total)
    # eager, capture + replay, replay, replay: the accumulator took each
    # step once, and every earlier result kept its value
    assert torch.equal(held["acc"], torch.full((3,), 12.0))
    assert [float(t) for t in sums] == [0.0, 6.0, 18.0, 36.0]
    assert (g.captures, s.captures, s.replays) == (1, 1, 3)
    assert _build.LAUNCHES["wkv6"] == 4
    # another batch dtype is another key: eager, then captured
    wide = {"x": torch.ones(3, dtype=torch.float64)}
    g(w, wide, held)
    assert g.captures == 1
    g(w, wide, held)
    assert g.captures == 2
    assert torch.equal(held["acc"], torch.full((3,), 16.0))
    _build.reset_launches()


def test_a_failed_step_capture_raises_naming_the_step(monkeypatch):
    monkeypatch.setattr(graphs, "BACKEND", StandIn(fail=True))
    g = graphs.StepGraph(lambda x: x + 1, "the granite decode step",
                         copied=(0,))
    g(torch.ones(2))
    with pytest.raises(RuntimeError, match="the granite decode step"):
        g(torch.ones(2))


def test_cpu_route_stays_eager():
    assert not graphs.applies(torch.device("cpu"))
    assert not graphs.applies(None)
    stream, state = _stream()
    stream.synchronize(state)
    assert not stream._compiled_cache
