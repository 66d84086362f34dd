"""The schedule lookup of ``STStream.synchronize`` on the CPU.

A call at the queue version of an earlier one (no enqueue since) returns
that call's scheduled programs without reading the queue; an enqueue
bumps the version, so the next call lowers and schedules the queue anew.
The state check keeps the windows' key set until ``create_window`` adds a
window. ``schedule_hits`` and ``schedule_builds`` count the two paths.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import STStream, halo
from repro_torch.core import stream as stream_mod
from repro_torch.core.autotune import ScheduleConfig

AXES, GRID, N, NITER = ("x", "y", "z"), (2, 2, 2), (4, 4, 4), 2
SYNC = dict(throttle="adaptive", resources=16, merged=True)
MODES = ("st", "host", "fused")


class _Unreadable(list):
    """A queue that raises when anything reads it."""

    def _read(self, *a, **k):
        raise AssertionError("the op queue was read")

    __iter__ = __len__ = __getitem__ = _read


def _faces(niter=NITER):
    stream = STStream("cpu", AXES, grid_shape=GRID)
    win, kernels = halo.build_faces_program(stream, N, niter, merged=True)
    return stream, win, kernels


def _state(stream):
    state = stream.allocate()
    gen = torch.Generator().manual_seed(0)
    state["faces.src"] = torch.rand(state["faces.src"].shape, generator=gen)
    return state


def _sched(mode):
    return dict(SYNC, fused=mode == "fused")


@pytest.mark.parametrize("mode", MODES)
def test_repeated_synchronize_reads_no_queued_op(monkeypatch, mode):
    stream, _, _ = _faces()
    state = _state(stream)
    first = stream.synchronize(state, mode=mode, **SYNC)
    progs = stream.scheduled_programs(**_sched(mode))
    assert (stream.schedule_builds, stream.schedule_hits) == (1, 1)
    lowered = []
    monkeypatch.setattr(stream_mod, "lower_segment",
                        lambda *a: lowered.append(a))
    monkeypatch.setattr(stream, "_ops", _Unreadable(stream._ops))
    for i in range(3):
        out = stream.synchronize(state, mode=mode, **SYNC)
        assert stream.schedule_hits == 2 + i
    assert stream.schedule_builds == 1 and not lowered
    got = stream.scheduled_programs(**_sched(mode))
    assert len(got) == len(progs)
    assert all(a is b for a, b in zip(got, progs))
    for k, v in first.items():
        assert torch.equal(out[k], v), k


@pytest.mark.parametrize("mode", MODES)
def test_enqueue_after_synchronize_rebuilds_and_equals_a_fresh_stream(mode):
    stream, win, kernels = _faces()
    state = _state(stream)
    stream.synchronize(state, mode=mode, **SYNC)
    before = stream.scheduled_programs(**_sched(mode))
    halo.enqueue_faces_iteration(stream, win, N, kernels, merged=True)
    out = stream.synchronize(state, mode=mode, **SYNC)
    assert stream.schedule_builds == 2
    after = stream.scheduled_programs(**_sched(mode))
    assert sum(len(p.nodes) for p in after) > \
        sum(len(p.nodes) for p in before)

    fresh, _, _ = _faces(NITER + 1)
    assert [op.kind for op in fresh.program] == \
        [op.kind for op in stream.program]
    want = fresh.synchronize(state, mode=mode, **SYNC)
    assert out.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(out[k], v), k


def test_two_knob_sets_get_two_schedules_and_each_repeat_hits():
    stream, _, _ = _faces()
    a = dict(SYNC, throttle="adaptive")
    b = dict(SYNC, throttle="static")
    pa, pb = stream.scheduled_programs(**a), stream.scheduled_programs(**b)
    assert stream.schedule_builds == 2 and stream.schedule_hits == 0
    assert not set(map(id, pa)) & set(map(id, pb))
    assert stream.scheduled_programs(**b) is pb
    assert stream.scheduled_programs(**a) is pa
    # a tuned config expands into the same knobs and finds the same entry
    cfg = ScheduleConfig(throttle="static", resources=16, merged=True)
    assert stream.scheduled_programs(config=cfg) is pb
    assert stream.scheduled_programs(config=cfg.to_dict()) is pb
    assert stream.schedule_builds == 2 and stream.schedule_hits == 4


def _missing(stream, state):
    return {k: v for k, v in state.items() if k != "faces.src"}


def _extra(stream, state):
    return dict(state, **{"faces.nope": state["faces.src"]})


def _on_meta(stream, state):
    return dict(state, **{"faces.acc": state["faces.acc"].to("meta")})


@pytest.mark.parametrize("bad,match", [
    (_missing, "state keys differ from the windows': \\['faces.src'\\]"),
    (_extra, "state keys differ from the windows': \\['faces.nope'\\]"),
    (_on_meta, "state\\['faces.acc'\\] is on meta, the stream on cpu"),
])
def test_state_checks_raise_the_same_before_and_after_warm(bad, match):
    stream, _, _ = _faces()
    state = _state(stream)
    with pytest.raises(ValueError, match=match) as cold:
        stream.synchronize(bad(stream, state), mode="st", **SYNC)
    stream.synchronize(state, mode="st", **SYNC)
    with pytest.raises(ValueError, match=match) as warm:
        stream.synchronize(bad(stream, state), mode="st", **SYNC)
    assert str(warm.value) == str(cold.value)


def test_window_created_after_synchronize_changes_the_accepted_keys():
    stream, _, _ = _faces()
    state = _state(stream)
    first = stream.synchronize(state, mode="st", **SYNC)
    stream.create_window("late", {"buf": ((3,), "float32")}, group=[])
    with pytest.raises(ValueError, match="late"):
        stream.synchronize(state, mode="st", **SYNC)
    grown = stream.allocate(init=dict(state))
    assert set(grown) - set(state) == {"late.buf", "late.post_sig",
                                       "late.comp_sig"}
    out = stream.synchronize(grown, mode="st", **SYNC)
    for k, v in first.items():
        assert torch.equal(out[k], v), k


def test_program_is_read_only():
    stream, win, _ = _faces()
    ops = stream.program
    assert isinstance(ops, tuple) and len(ops) == stream._version
    with pytest.raises(AttributeError):
        stream.program.append(ops[0])
    with pytest.raises(AttributeError):
        stream.program = []
    stream.scheduled_programs(**SYNC)
    stream.post(win)
    assert len(stream.program) == len(ops) + 1
    stream.scheduled_programs(**SYNC)
    assert stream.schedule_builds == 2
