"""The program's spans (``repro_torch.core.spans``) on the CPU.

Under ``torch.profiler`` (host activity only), ``STStream.synchronize``
and ``ServingEngine.step`` open the spans the module's docstring lists,
nested as it lists them, which is checked by each span's start and end.
The graphs' spans come from the stand-in capture object of
``tests/test_torch_graphs.py``, which replays on the CPU. With no
profiler running, no span is entered at all.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core import STStream, graphs, halo
from repro_torch.core.spans import span
from repro_torch.models import init_params, model_specs
from repro_torch.serving import Request, ServingEngine
from test_torch_graphs import TINY, StandIn

GRID, N, NITER = (2, 2, 2), (4, 3, 5), 2
SYNC = {"st": dict(mode="st"), "host": dict(mode="host"),
        "fused": dict(mode="fused"),
        "fused-2streams": dict(mode="fused", nstreams=2)}


def _stream():
    stream = STStream("cpu", ("x", "y", "z"), grid_shape=GRID)
    halo.build_faces_program(stream, N, NITER, merged=True)
    state = stream.allocate()
    state["faces.src"] = torch.from_numpy(
        np.random.RandomState(0).rand(8, *N).astype(np.float32))
    return stream, state


class Span:
    def __init__(self, e):
        self.name = e.name[len("repro_torch."):]
        self.start, self.end = e.time_range.start, e.time_range.end

    def __repr__(self):
        return f"{self.name}[{self.start}, {self.end}]"


def _spans(fn):
    """fn() under the profiler: its program spans in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = [Span(e) for e in prof.events()
           if e.name.startswith("repro_torch.")]
    return sorted(out, key=lambda s: (s.start, -s.end))


def _within(spans, outer, name=None):
    """The spans inside ``outer`` (by times), or those named ``name``."""
    return [s for s in spans if s is not outer
            and outer.start <= s.start and s.end <= outer.end
            and (name is None or s.name == name)]


def _children(spans, outer):
    """The names of ``outer``'s direct children, in order."""
    inner = _within(spans, outer)
    return [s.name for s in inner
            if not any(s in _within(spans, o) for o in inner)]


@pytest.mark.parametrize("sync", list(SYNC))
def test_synchronize_on_the_eager_route(sync):
    stream, state = _stream()
    spans = _spans(lambda: stream.synchronize(state, **SYNC[sync]))
    sync_span, = [s for s in spans if s.name == "st.sync"]
    # the CPU route emits eagerly: no graph, no graph lookup
    assert _children(spans, sync_span) == ["st.lookup", "st.block"]
    assert len(_within(spans, sync_span)) == len(spans) - 1


@pytest.mark.parametrize("sync", ["st", "fused", "fused-2streams"])
def test_synchronize_through_the_graphs(monkeypatch, sync):
    monkeypatch.setattr(graphs, "BACKEND", StandIn())
    stream, state = _stream()
    stream.synchronize(state, **SYNC[sync])         # warm-up, capture
    spans = _spans(lambda: stream.synchronize(state, **SYNC[sync]))
    sync_span, = [s for s in spans if s.name == "st.sync"]
    prog, = stream._fused_cache.values() if sync != "st" else \
        stream._compiled_cache.values()
    assert _children(spans, sync_span) == (
        ["st.lookup", "st.lookup", "graph.copy_in"]
        + ["graph.replay"] * len(prog.chain)
        + ["graph.copy_out", "st.block"])
    assert len(prog.chain) > (1 if sync == "fused-2streams" else 0)


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(), **TINY)
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu", getattr(torch, cfg.compute_dtype))
    return cfg, params


def _engine(tiny):
    """An ST-routed engine on 3 slots, and requests that admit a length
    group into slots 0-2 (one cache view), then, when the first and the
    last finish together, a second group into slots 0 and 2 (a gather
    and its write-back)."""
    cfg, params = tiny
    eng = ServingEngine(cfg, params, batch_slots=3, max_len=64,
                        st_mode="st", st_config=None, device="cpu")
    rng = np.random.RandomState(1)
    for L, m in ((5, 2), (5, 6), (5, 2), (7, 3), (7, 3)):
        eng.submit(Request(prompt=rng.randint(1, cfg.vocab_size, L)
                           .astype(np.int32), max_new_tokens=m))
    return eng


def _serve_spans(eng):
    spans = _spans(eng.run_until_drained)
    assert not eng.queue and not eng._active()
    return spans, [s for s in spans if s.name == "engine.step"]


def test_engine_step_spans(monkeypatch, tiny):
    stand_in = StandIn()
    monkeypatch.setattr(graphs, "BACKEND", stand_in)
    cfg, _ = tiny
    eng = _engine(tiny)
    spans, steps = _serve_spans(eng)
    assert len(steps) == eng.decode_steps
    assert stand_in.replays > 0
    # every span but the steps is inside a step
    for s in spans:
        assert s.name == "engine.step" or any(
            s in _within(spans, t) for t in steps), s
    gathered = 0
    for step in steps:
        kids = _children(spans, step)
        assert kids == ["engine.admit", "engine.decode", "router.dispatch",
                        "engine.record"], kids
        admit, = _within(spans, step, "engine.admit")
        for pre in _within(spans, admit, "engine.prefill"):
            kids = _children(spans, pre)
            gathered += "engine.scatter" in kids
            assert kids in (
                ["engine.gather", "engine.forward", "engine.readback"],
                ["engine.gather", "engine.forward", "engine.scatter",
                 "engine.readback"]), kids
        assert _children(spans, admit) == ["engine.prefill"] * len(
            _within(spans, admit, "engine.prefill"))
        dec, = _within(spans, step, "engine.decode")
        assert _children(spans, dec) in (
            ["engine.upload"] + ["model.attn"] * cfg.num_layers
            + ["engine.readback"],                            # the warm-up
            ["engine.upload", "graph.copy_in", "graph.replay",
             "graph.copy_out", "engine.readback"]), _children(spans, dec)
        rd, = _within(spans, step, "router.dispatch")
        assert _children(spans, rd) == ["router.stage", "st.sync",
                                        "router.readback"]
        sync_span, = _within(spans, rd, "st.sync")
        assert _children(spans, sync_span)[:2] == ["st.lookup", "st.lookup"]
        assert _children(spans, sync_span)[-1] == "st.block"
    # both prefill routes: the view and the gather with its write-back
    assert gathered == 1
    assert sum(len(_within(spans, s, "engine.prefill")) for s in steps) == 2
    # the decode step: eager, then captured and replayed, then replayed
    decodes = [s for s in spans if s.name == "engine.decode"]
    assert sum(len(_within(spans, d, "graph.replay")) for d in decodes) \
        == eng.decode_steps - 1


@pytest.fixture
def raising(monkeypatch):
    """``torch.profiler.record_function`` replaced by one that raises."""
    def record_function(name):
        raise AssertionError(f"span {name} entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    with pytest.raises(AssertionError, match="no profiler"):
        torch.profiler.record_function("x")


@pytest.mark.parametrize("sync", list(SYNC))
def test_no_span_without_a_profiler_synchronize(monkeypatch, raising, sync):
    monkeypatch.setattr(graphs, "BACKEND", StandIn())
    stream, state = _stream()
    for _ in range(3):                       # warm-up, capture, replay
        stream.synchronize(state, **SYNC[sync])


def test_no_span_without_a_profiler_engine(monkeypatch, raising, tiny):
    monkeypatch.setattr(graphs, "BACKEND", StandIn())
    eng = _engine(tiny)
    eng.run_until_drained()
    assert eng.decode_steps > 2
    assert span("repro_torch.a") is span("repro_torch.b")


def test_mla_forward_opens_a_span_per_mla_mixer():
    """Under the profiler, the eager forward of the reduced
    deepseek-v2-lite (an MLA mixer in each layer, the dense FFN first,
    then MoE) opens ``repro_torch.model.mla`` once a layer and ``.moe``
    once an MoE layer; with no profiler, none."""
    from repro_torch.models import forward
    cfg = dataclasses.replace(get_config("deepseek-v2-lite").reduced(),
                              num_layers=3, compute_dtype="float32")
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    batch = {"tokens": torch.zeros((1, 5), dtype=torch.long),
             "positions": torch.arange(5)[None]}
    names = [s.name for s in _spans(lambda: forward(cfg, params, batch,
                                                    moe_impl="dense"))]
    assert sorted(names) == ["model.mla"] * 3 + ["model.moe"] * 2


def test_no_span_without_a_profiler_mla_forward(raising):
    from repro_torch.models import forward
    cfg = dataclasses.replace(get_config("deepseek-v2-lite").reduced(),
                              compute_dtype="float32")
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    forward(cfg, params, {"tokens": torch.zeros((1, 5), dtype=torch.long),
                          "positions": torch.arange(5)[None]},
            moe_impl="dense")
