"""The program spans in a traced slice (``stbench/span_idle.py``), on a
fixed list of fake profiler events: the keys ``devtrace.Trace.reduce``
gives are the same with and without the program's spans among the
events, the span reduction matches hand counts, and each reading gives
its hand value, or None where the slice has no program span."""
import math
import os
import sys
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from torch.autograd import DeviceType  # noqa: E402

from stbench import span_idle  # noqa: E402
from stbench.devtrace import Trace  # noqa: E402

P = "repro_torch."


class Event:
    def __init__(self, name, a, b, device=False, user=False):
        self._name, self._a, self._b = name, a, b
        self._dev, self._user = device, user

    def name(self):
        return self._name

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def is_user_annotation(self):
        return self._user


# one Faces program on the host (ns): its spans, what runs inside them
SPANS = [(P + "st.sync", 90, 3200), (P + "st.lookup", 100, 1100),
         (P + "st.lookup", 1200, 1300), (P + "graph.copy_in", 1300, 1600),
         (P + "graph.replay", 1600, 2600),
         (P + "graph.copy_out", 2600, 3000), (P + "st.block", 3000, 3100)]
HOST = [("stbench.traced", 0, 10000),
        ("aten::_foreach_copy_", 1350, 1550),
        ("cudaLaunchKernel", 1400, 1500), ("cudaGraphLaunch", 1650, 2300),
        ("aten::add_", 2350, 2550), ("aten::empty", 2620, 2700),
        ("aten::_foreach_copy_", 2700, 2900),
        ("cudaLaunchKernel", 2750, 2780),
        ("cudaDeviceSynchronize", 3010, 3090)]
DEVICE = [("copy", 50, 80), ("copy", 1450, 1520), ("kernel_a", 2000, 2400),
          ("kernel_b", 2450, 2800), ("copy", 2850, 2950),
          ("kernel_a", 6000, 6100)]
# the device's side of the profiler's ranges: user annotations
ANNOTATIONS = [("stbench.traced", 50, 6100),
               (P + "graph.replay", 2000, 2800)]
WINDOW_S = 10e-6


def _events(spans):
    evs = [Event(n, a, b) for n, a, b in HOST]
    evs += [Event(n, a, b, device=True) for n, a, b in DEVICE]
    if spans:
        evs += [Event(n, a, b) for n, a, b in SPANS]
        evs += [Event(n, a, b, device=True, user=True)
                for n, a, b in ANNOTATIONS]
    return evs


def _reduce(evs):
    tr = Trace(None)
    tr._prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))
    tr._t = WINDOW_S
    return tr.reduce()


@pytest.mark.parametrize("key", ["window_s", "busy_s", "device_ops",
                                 "host_calls"])
def test_program_spans_leave_the_trace_keys_as_they_were(key):
    plain, spanned = _reduce(_events(False)), _reduce(_events(True))
    assert spanned[key] == plain[key]
    want = {"window_s": WINDOW_S, "busy_s": 1050e-9,
            "device_ops": {"copy": [3, 200e-9], "kernel_a": [2, 500e-9],
                           "kernel_b": [1, 350e-9]},
            "host_calls": {"cudaLaunchKernel": 2, "cudaGraphLaunch": 1}}[key]
    if key == "device_ops":
        assert {k: v[0] for k, v in plain[key].items()} == \
            {k: v[0] for k, v in want.items()}
        for k, (_, s) in want.items():
            assert math.isclose(plain[key][k][1], s)
    elif key in ("window_s", "busy_s"):
        assert math.isclose(plain[key], want)
    else:
        assert plain[key] == want


def test_idle_gaps_name_the_innermost_host_event():
    plain, spanned = _reduce(_events(False)), _reduce(_events(True))
    # gaps (ns): [80, 1450] mid 765, [1520, 2000] mid 1760, [2400, 2450]
    # mid 2425, [2800, 2850] mid 2825, [2950, 6000] mid 4475
    want = {"stbench.traced": 3050e-9, "cudaGraphLaunch": 480e-9,
            "aten::add_": 50e-9, "aten::_foreach_copy_": 50e-9}
    assert set(spanned["idle_gaps"]) == set(want) | {P + "st.lookup",
                                                     "edges"}
    assert math.isclose(spanned["idle_gaps"][P + "st.lookup"], 1370e-9)
    for k, v in want.items():
        assert math.isclose(spanned["idle_gaps"][k], v)
    assert math.isclose(plain["idle_gaps"]["stbench.traced"],
                        (3050 + 1370) * 1e-9)
    assert math.isclose(spanned["idle_gaps"]["edges"],
                        plain["idle_gaps"]["edges"])
    assert math.isclose(plain["idle_gaps"]["edges"], WINDOW_S - 6050e-9)


def test_spans_and_idle_by_span_match_hand_counts():
    host, gaps = span_idle.host_and_gaps(_events(True))
    assert gaps == [(80, 1450), (1520, 2000), (2400, 2450), (2800, 2850),
                    (2950, 6000)]
    red = span_idle.reduce_spans(host, gaps)
    assert red["spans"] == {
        P + "st.sync": [1, 3110e-9], P + "st.lookup": [2, 1100e-9],
        P + "graph.copy_in": [1, 300e-9], P + "graph.replay": [1, 1000e-9],
        P + "graph.copy_out": [1, 400e-9], P + "st.block": [1, 100e-9]}
    sync = P + "st.sync/" + P
    want = {sync + "st.lookup": 1370e-9,
            # under cudaGraphLaunch, and under an aten op, in the replay
            sync + "graph.replay": 530e-9,
            sync + "graph.copy_out": 50e-9,
            "": 3050e-9}
    assert set(red["idle_by_span"]) == set(want)
    for k, v in want.items():
        assert math.isclose(red["idle_by_span"][k], v), k
    # the same gaps as idle_gaps, whose edges lie outside them
    idle = _reduce(_events(True))["idle_gaps"]
    assert math.isclose(sum(red["idle_by_span"].values()),
                        sum(idle.values()) - idle["edges"])
    assert span_idle.launches_in_replay(host) == [1, 1]


def test_without_program_spans_every_gap_is_on_the_empty_path():
    host, gaps = span_idle.host_and_gaps(_events(False))
    red = span_idle.reduce_spans(host, gaps)
    assert red["spans"] == {}
    assert list(red["idle_by_span"]) == [""]
    assert math.isclose(red["idle_by_span"][""], 5000e-9)
    for name in span_idle.READINGS:
        assert span_idle.read(red, name) is None, name


def test_nested_spans_that_start_together_give_the_outer_first():
    host = [(0, 100, P + "a"), (0, 50, P + "b"), (60, 100, P + "c")]
    red = span_idle.reduce_spans(host, [(10, 20), (70, 80), (120, 130)])
    assert red["idle_by_span"] == pytest.approx(
        {P + "a/" + P + "b": 10e-9, P + "a/" + P + "c": 10e-9, "": 10e-9})


E, D, R = P + "engine.", P + "engine.step/" + P + "engine.decode/", \
    P + "engine.step/" + P + "router.dispatch/"
PRE = P + "engine.step/" + E + "admit/" + E + "prefill/"
SERVED = {
    "spans": {E + "decode": [4, 0.03], E + "prefill": [2, 0.1],
              P + "st.sync": [4, 0.004]},
    "idle_by_span": {
        D + P + "graph.replay": 0.004, D + E + "upload": 0.001,
        D + P + "graph.copy_in": 0.0005, D[:-1]: 0.0002,
        R + P + "st.sync/" + P + "graph.replay": 0.002,
        R + P + "router.stage": 0.001, R[:-1]: 0.0001,
        PRE + E + "forward": 0.006, PRE + E + "gather": 0.0004,
        PRE + E + "scatter": 0.0002, PRE[:-1]: 0.0003, "": 0.003}}
FACES = span_idle.reduce_spans(*span_idle.host_and_gaps(_events(True)))


@pytest.mark.parametrize("name, red, want", [
    ("st_lookup_idle_ms.faces", FACES, 1370e-6),
    ("st_launch_idle_ms.faces", FACES, 530e-6),
    ("decode_launch_idle_ms.decode", SERVED, 1e3 * 0.004 / 4),
    ("decode_upload_idle_ms.decode", SERVED, 1e3 * 0.0015 / 4),
    ("router_idle_ms.decode", SERVED, 1e3 * 0.0031 / 4),
    ("prefill_forward_idle_ms.prefill", SERVED, 1e3 * 0.006 / 2),
    ("prefill_cache_idle_ms.prefill", SERVED, 1e3 * 0.0006 / 2)])
def test_each_reading_gives_its_hand_value(name, red, want):
    assert math.isclose(span_idle.read(red, name), want)
    # None on a slice without program spans, as a program without them
    # gives, and without the span it counts by
    bare = {"spans": {}, "idle_by_span": {"": 1.0}}
    assert span_idle.read(bare, name) is None
    per = span_idle.READINGS[name][2]
    assert span_idle.read(dict(red, spans={
        k: v for k, v in red["spans"].items() if k != per}), name) is None


def test_faces_slice_has_no_serving_reading():
    for name in span_idle.READINGS:
        if not name.endswith(".faces"):
            assert span_idle.read(FACES, name) is None, name


def test_by_hand_run_prints_the_span_keys(monkeypatch, capsys):
    # the cell's run stood in for: a traced run's reduction of the fake
    # events, through the Trace the driver would build
    import json
    from stbench import devtrace, harness
    plain = devtrace.Trace

    def run_cell(bench, workload, **kw):
        tr = devtrace.Trace(None)
        assert type(tr) is not plain
        tr._prof = SimpleNamespace(profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: _events(True))))
        tr._t = WINDOW_S
        tr.reduce()
        return {"correct": True}, {}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(harness, "run_cell", run_cell)
    assert span_idle.main(["--workload", "faces-64r-n64", "--seed", "1",
                           "--seconds", "1"]) == 0
    assert devtrace.Trace is plain
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = out["span_idle"]
    assert out["correct"] and got["launches_in_replay"] == [1, 1]
    assert got["readings"]["st_lookup_idle_ms.faces"] == \
        pytest.approx(1370e-6)
    assert got["readings"]["router_idle_ms.decode"] is None
    assert got["empty_path_share"] == pytest.approx(3050 / 5000)
