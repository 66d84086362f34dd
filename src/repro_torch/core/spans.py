"""The program's own spans on the profiler's timeline.

:func:`span` opens a ``torch.profiler.record_function`` range while a
``torch.profiler`` session runs, and does nothing otherwise (one C call
to ask whether a profiler is on, and a shared ``nullcontext``): there is
no switch of its own. Spans are profiler events, on the clock of the
device records that CUPTI takes beside them, so a stretch in which the
device idles can be put down to the span the host was in.

To see them, profile any work of the program, for example::

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.step()
    prof.export_chrome_trace("trace.json")   # chrome://tracing, Perfetto

The spans, nested as listed (a name can open more than once in a call):

  * ``repro_torch.st.sync``: ``STStream.synchronize``, the whole call;
    inside it ``repro_torch.st.lookup`` (the argument checks and the
    scheduled programs' cache key over the queue; again in the st and
    fused executors, the program graph's lookup), the program graph's
    ``repro_torch.graph.copy_in`` (the state into its static inputs),
    ``repro_torch.graph.replay`` (one a graph: the graph launch) and
    ``repro_torch.graph.copy_out`` (fresh copies of its outputs), and
    ``repro_torch.st.block`` (the host sync after each program);
  * ``repro_torch.engine.step``: ``ServingEngine.step``, with
    ``repro_torch.engine.admit`` (one ``repro_torch.engine.prefill`` a
    length group: ``engine.gather`` (the slots' cache view or gather,
    their state zeroed), ``engine.forward`` (the eager prefill),
    ``engine.scatter`` (a gather's rows written back) and
    ``engine.readback`` (the first ids to the host));
    ``repro_torch.engine.decode`` (``engine.upload``: tokens and
    positions to the device; the decode graph's ``graph.copy_in``,
    ``graph.replay`` and ``graph.copy_out``; ``engine.readback``);
    ``repro_torch.router.dispatch`` (the ST router: ``router.stage``,
    the payloads staged and the counters zeroed; its stream's
    ``st.sync``; ``router.readback``, the committed rows to the host);
    ``repro_torch.engine.record`` (the new tokens appended, finished
    slots recycled).

In the model's eager forward (a prefill; a decode step's warm-up, not
its graph's replays), each mixer or FFN call of the kinds that set
architectures apart opens one: ``repro_torch.model.attn`` (a self
attention mixer), ``repro_torch.model.mamba`` (a Mamba mixer),
``repro_torch.model.mla`` (a multi-head latent attention mixer),
``repro_torch.model.moe`` (an MoE FFN).

Kernel wrappers, the other layers and descriptor emission open none:
they run once a descriptor or a layer, and the profiler's own operator
and CUDA runtime events already name them.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


class _Capture:
    """How many graph captures (``core/graphs.py``) are under way."""
    depth = 0


@contextlib.contextmanager
def capturing():
    """Around a graph's capture: no span opens inside it."""
    _Capture.depth += 1
    try:
        yield
    finally:
        _Capture.depth -= 1


def span(name: str):
    """A context manager: ``name``'s profiler range while a profiler
    runs and no graph is being captured, else a shared no-op."""
    if torch._C._autograd._profiler_enabled() and not _Capture.depth:
        return torch.profiler.record_function(name)
    return _OFF
