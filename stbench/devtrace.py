"""The device trace of a traced run: ``torch.profiler`` (CUPTI) over a
slice of the measured window, reduced to what the per-layer readers
take.

The slice starts and ends with the device idle (a synchronize on each
side), so the device work the profiler records is the slice's whole
work. From the profiler's raw events:

  * ``window_s``: the slice's length on the host clock; ``busy_s``: the
    union of the intervals in which a kernel, copy or memset ran on the
    device;
  * ``device_ops``: {name: [count, seconds]} of the device's operations;
  * ``host_calls``: {name: count} of the host's CUDA API calls that put
    work on the device (graph and kernel launches, async copies and
    memsets);
  * ``idle_gaps``: {what the host was doing: seconds} over the stretches
    between device operations, each put down to the innermost host
    operation open at its middle (the span ``stbench.traced`` where none
    is), and the slice's time before the first and after the last device
    operation as ``edges``.
"""
from __future__ import annotations

import re
import time
from collections import defaultdict

SPAN = "stbench.traced"
ENQUEUE_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
                 "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
                 "cudaMemsetAsync", "cudaLaunchCooperativeKernel")


def _times(e):
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return 1000 * e.start_us(), 1000 * (e.start_us() + e.duration_us())


class Trace:
    """Profiles what runs between :meth:`start` and :meth:`stop` (both
    synchronize the device); :meth:`reduce` reads the result."""

    def __init__(self, device):
        self.device = device
        self._prof = self._span = None

    def warm(self):
        """Profile one small operation: the profiler's first session
        initializes CUPTI for seconds, which belongs to set-up."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=self.device).add_(1)
            torch.cuda.synchronize(self.device)

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._span = torch.profiler.record_function(SPAN)
        self._span.__enter__()
        self._t = time.perf_counter()

    def stop(self):
        import torch
        torch.cuda.synchronize(self.device)
        self._t = time.perf_counter() - self._t
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        from torch.autograd import DeviceType
        t0 = time.perf_counter()
        events = self._prof.profiler.kineto_results.events()
        dev, host, spans = [], [], []
        for e in events:
            name = e.name()
            a, b = _times(e)
            if e.device_type() == DeviceType.CUDA:
                user = getattr(e, "is_user_annotation", None)
                if name.startswith("stbench.") or (user and user()):
                    continue
                dev.append((a, b, name))
            elif name == SPAN:
                spans.append((a, b))
            else:
                host.append((a, b, name))
        if not dev:
            raise RuntimeError("device trace: no device operation recorded")
        dev.sort()
        busy, gaps = 0, []
        ops = defaultdict(lambda: [0, 0.0])
        cur_a, cur_b = dev[0][0], dev[0][0]
        for a, b, name in dev:
            ops[name][0] += 1
            ops[name][1] += (b - a) / 1e9
            if a > cur_b:
                busy += cur_b - cur_a
                gaps.append((cur_b, a))
                cur_a = a
            cur_b = max(cur_b, b)
        busy += cur_b - cur_a
        lo = min((a for a, _ in spans), default=dev[0][0])
        hi = max((b for _, b in spans), default=cur_b)
        calls = defaultdict(int)
        for a, b, name in host:
            if name in ENQUEUE_CALLS:
                calls[name] += 1
        # sweep: host events by start, gaps by middle; the innermost open
        # event is the latest started one that has not ended (host
        # operations nest on the thread that issues the work)
        idle = defaultdict(float)
        host.sort()
        stack, i = [], 0
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            while i < len(host) and host[i][0] <= mid:
                while stack and stack[-1][1] < host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            idle[stack[-1][2] if stack else SPAN] += (g1 - g0) / 1e9
        idle["edges"] = max(self._t - (cur_b - dev[0][0]) / 1e9, 0.0)
        diag = {"host_span_s": (hi - lo) / 1e9, "spans": len(spans),
                "device_first_minus_span_ms": (dev[0][0] - lo) / 1e6,
                "device_last_minus_span_ms": (cur_b - hi) / 1e6}
        return {"window_s": self._t, "busy_s": busy / 1e9,
                "device_ops": {k: list(v) for k, v in ops.items()},
                "host_calls": dict(calls), "idle_gaps": dict(idle),
                "events": len(events), "diag": diag,
                "reduce_s": time.perf_counter() - t0}


def breakdown(red: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the host's doings over the longest idle stretches."""
    ops = sorted(((v[1], k) for k, v in red["device_ops"].items()),
                 reverse=True)[:top]
    idle = sorted(((v, k) for k, v in red["idle_gaps"].items()),
                  reverse=True)[:top]
    return {"device_ops": [[k[:200], s] for s, k in ops],
            "idle_gaps": [[k[:200], s] for s, k in idle]}


def kernel_stats(red: dict, kernels) -> tuple:
    """(launches, device seconds) of the device functions named in
    ``kernels``, wherever the name stands in the profiler's signature
    (``void (anonymous namespace)::unpack_kernel<float, 4, true>(...)``)."""
    pat = re.compile("|".join(r"(?<!\w)" + re.escape(k) + r"(?!\w)"
                              for k in kernels))
    n, s = 0, 0.0
    for name, (count, secs) in red["device_ops"].items():
        if pat.search(name):
            n += count
            s += secs
    return n, s
