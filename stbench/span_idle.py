"""The device's idle time in a traced slice, put down to the program's
own spans.

While a profiler runs, the program opens spans on the profiler's
timeline (``repro_torch.core.spans``: ``repro_torch.st.sync``,
``repro_torch.engine.step`` and the spans nested in them), on the clock
of CUPTI's device records. From a profiled slice's raw events:

  * ``spans``: {span name: [count, host seconds]} over the host events
    whose name starts with ``repro_torch.``;
  * ``idle_by_span``: {path: seconds} over the idle gaps that
    ``devtrace.Trace.reduce`` forms (the stretches between device
    operations), a gap's path being the names of the program spans open
    at its middle, outermost first, joined by ``/``, whatever operator
    or CUDA runtime call is open inside them; ``""`` where none is.

``READINGS`` are the per-layer quantities these give: the idle ms under
a set of paths over the count of one span, None where the slice has no
such span (a program without spans). ``Trace.reduce`` does not add the
two keys yet; run by hand on the card,

    python3 stbench/span_idle.py --workload <name> --seed <n> --seconds <s>

runs the cell as a traced benchmark run does and prints its result line
with the two keys, the readings, the share of idle under the empty path
and the graph launches that lie inside a ``repro_torch.graph.replay``
span, as one JSON line.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

PREFIX = "repro_torch."
REPLAY = "repro_torch.graph.replay"

# name: (paths ending in one of, paths containing, divided by the count of)
READINGS = {
    "st_lookup_idle_ms.faces": (
        ("repro_torch.st.lookup",), None, "repro_torch.st.sync"),
    "st_launch_idle_ms.faces": (
        (REPLAY,), None, "repro_torch.st.sync"),
    "decode_launch_idle_ms.decode": (
        (REPLAY,), "repro_torch.engine.decode", "repro_torch.engine.decode"),
    "decode_upload_idle_ms.decode": (
        ("repro_torch.engine.upload", "repro_torch.graph.copy_in"),
        "repro_torch.engine.decode", "repro_torch.engine.decode"),
    "router_idle_ms.decode": (
        None, "repro_torch.router.dispatch", "repro_torch.engine.decode"),
    "prefill_forward_idle_ms.prefill": (
        ("repro_torch.engine.forward",), None, "repro_torch.engine.prefill"),
    "prefill_cache_idle_ms.prefill": (
        ("repro_torch.engine.gather", "repro_torch.engine.scatter"), None,
        "repro_torch.engine.prefill"),
}


def host_and_gaps(events):
    """(host events, idle gaps) of the profiler's raw events, as
    ``devtrace.Trace.reduce`` forms them: host events (a, b, name) in ns;
    gaps (start, end) in ns between the merged device operations."""
    from torch.autograd import DeviceType
    from stbench.devtrace import SPAN, _times
    dev, host = [], []
    for e in events:
        name = e.name()
        a, b = _times(e)
        if e.device_type() == DeviceType.CUDA:
            user = getattr(e, "is_user_annotation", None)
            if name.startswith("stbench.") or (user and user()):
                continue
            dev.append((a, b))
        elif name != SPAN:
            host.append((a, b, name))
    dev.sort()
    gaps = []
    cur_b = dev[0][0] if dev else 0
    for a, b in dev:
        if a > cur_b:
            gaps.append((cur_b, a))
        cur_b = max(cur_b, b)
    return host, gaps


def reduce_spans(host, gaps) -> dict:
    """``spans`` and ``idle_by_span`` (see the module doc) of host
    events (a, b, name) and idle gaps (start, end), in ns."""
    spans = sorted(((a, b, n) for a, b, n in host if n.startswith(PREFIX)),
                   key=lambda s: (s[0], -s[1]))
    count = defaultdict(lambda: [0, 0.0])
    for a, b, name in spans:
        count[name][0] += 1
        count[name][1] += (b - a) / 1e9
    # sweep: spans by start (the outer first), gaps by middle; the spans
    # open at a middle, in the order they started, are its path (spans
    # nest on the thread that issues the work)
    idle = defaultdict(float)
    opened, i = [], 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) / 2
        while i < len(spans) and spans[i][0] <= mid:
            opened.append(spans[i])
            i += 1
        opened = [s for s in opened if s[1] >= mid]
        idle["/".join(s[2] for s in opened)] += (g1 - g0) / 1e9
    return {"spans": {k: list(v) for k, v in count.items()},
            "idle_by_span": dict(idle)}


def read(red: dict, name: str):
    """READINGS[name] of a reduction holding ``spans`` and
    ``idle_by_span``, in ms a span; None where the span it counts by is
    absent."""
    ending, containing, per = READINGS[name]
    n = (red.get("spans") or {}).get(per, [0])[0]
    if not n:
        return None
    s = 0.0
    for path, secs in red["idle_by_span"].items():
        names = path.split("/") if path else []
        if ending is not None and (not names or names[-1] not in ending):
            continue
        if containing is not None and containing not in names:
            continue
        s += secs
    return 1e3 * s / n


def launches_in_replay(host) -> list:
    """[graph launches inside a ``repro_torch.graph.replay`` span by their
    timestamps, all graph launches] of the host events."""
    replays = sorted((a, b) for a, b, n in host if n == REPLAY)
    launches = [(a, b) for a, b, n in host if n == "cudaGraphLaunch"]
    inside = sum(any(r0 <= a and b <= r1 for r0, r1 in replays)
                 for a, b in launches)
    return [inside, len(launches)]


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="stbench/span_idle.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    from stbench import devtrace, harness
    if not torch.cuda.is_available():
        print("stbench/span_idle.py: needs a CUDA card", file=sys.stderr)
        return 2
    seen = []

    class SpanTrace(devtrace.Trace):
        def reduce(self):
            red = super().reduce()
            host, gaps = host_and_gaps(
                self._prof.profiler.kineto_results.events())
            red.update(reduce_spans(host, gaps))
            red["launches_in_replay"] = launches_in_replay(host)
            seen.append(red)
            return red

    plain, devtrace.Trace = devtrace.Trace, SpanTrace
    try:
        result, _ = harness.run_cell(
            harness.load_benchmark(), args.workload, seed=args.seed,
            seconds=args.seconds, trace=True,
            device=torch.device("cuda", 0), t_start=T_START)
    finally:
        devtrace.Trace = plain
    red, = seen
    idle = sum(red["idle_gaps"].values()) - red["idle_gaps"]["edges"]
    result["span_idle"] = {
        "readings": {k: read(red, k) for k in READINGS},
        "empty_path_share": red["idle_by_span"].get("", 0.0) / idle
        if idle else None,
        "idle_net_of_edges_s": idle,
        "launches_in_replay": red["launches_in_replay"],
        "window_s": red["window_s"], "host_calls": red["host_calls"],
        "idle_gaps": red["idle_gaps"], "spans": red["spans"],
        "idle_by_span": red["idle_by_span"]}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
        ROOT, "build", "stbench", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "stbench",
                                                  "triton")
    sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]
    sys.exit(main(sys.argv[1:]))
