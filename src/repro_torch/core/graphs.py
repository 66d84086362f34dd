"""CUDA-graph capture and replay: the port's counterpart of the JAX
package's ``jax.jit``.

The JAX package never runs its ST program op by op: ``run_compiled`` and
``run_fused`` trace a whole scheduled program into one jitted executable,
cached on the stream, and the serving engine jits its decode step. Here a
function of tensors is captured once as a CUDA graph
(``torch.cuda.CUDAGraph`` under ``torch.cuda.graph``) and every later call
replays it: the host launches one graph where it launched every kernel.

  * :class:`ProgramGraph` — a function of a state dict (a scheduled ST
    program; a fused program's segments, one graph each, captured in wave
    order into one shared memory pool, so that each segment reads the
    previous one's outputs at fixed addresses). The caller's tensors are
    copied into static inputs before each replay and the outputs copied
    out after it, so a state handed in is never modified and a result the
    caller holds never changes when the graph is replayed again. A key
    that no descriptor writes (its output is its static input: emission
    rebinds every key it writes to a new tensor) is returned as the
    caller's own tensor, which equals it by construction. The
    first call warms up: it runs the function once eagerly on the static
    copies and throws the result away (kernel libraries and CUDA modules
    loaded, the caching allocator grown, all outside the capture), then
    captures.
  * :class:`StepGraph` — a step function whose arguments are partly
    copied (a decode step's tokens and positions, into static buffers)
    and partly held (the weights and the cache, which the graph reads and
    writes at their addresses). The first call of a key runs eagerly and
    is the warm-up; the second captures; every later call replays.

Kernel launches: a wrapper adds to ``_build.LAUNCHES`` when Python calls
it, which under capture happens once and launches nothing. So a capture
records each graph's ``LAUNCHES`` delta and restores the counts, and
every replay adds the delta: ``LAUNCHES`` counts the kernels that ran.

A capture or replay that fails raises, naming the program or step; there
is no eager fallback. A kernel closure that syncs the host or copies from
it (``.item()``, ``torch.tensor(..., device="cuda")``) fails here, as it
would under ``jax.jit``.

:data:`BACKEND` is the capture object: CUDA graphs, for CUDA devices. The
CPU route stays eager (``applies`` is False there).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from repro_torch.core.spans import capturing, span
from repro_torch.kernels import _build


class CudaGraphs:
    """Capture on a CUDA device: ``torch.cuda.CUDAGraph`` under
    ``torch.cuda.graph`` (which synchronizes the device on entry and
    captures on a side stream of its own)."""

    @staticmethod
    def applies(device) -> bool:
        return device is not None and torch.device(device).type == "cuda"

    @staticmethod
    def pool():
        return torch.cuda.graph_pool_handle()

    @staticmethod
    def synchronize():
        torch.cuda.synchronize()

    @staticmethod
    def capture(fn, inputs, pool):
        """(graph, fn(inputs)): fn's kernels recorded in the graph, not
        run; the outputs live in the graph's memory pool."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            out = fn(inputs)
        return graph, out


BACKEND = CudaGraphs()


def applies(device) -> bool:
    """Whether entry points on ``device`` replay graphs (CUDA) or run
    eagerly (the CPU)."""
    return BACKEND.applies(device)


# ---------------------------------------------------------------------------
# one captured graph, with its launch accounting
# ---------------------------------------------------------------------------

class _Captured:
    """One graph: ``fn(inputs)`` captured, its outputs (``out``) and its
    launch delta."""

    def __init__(self, name: str, fn, inputs, pool):
        self.name = name
        before = dict(_build.LAUNCHES)
        try:
            with capturing():
                self.graph, self.out = BACKEND.capture(fn, inputs, pool)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {name} failed: "
                               f"{e}") from e
        finally:
            # the wrappers counted launches that did not run
            self.delta = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                          if v != before[k]}
            _build.LAUNCHES.update(before)

    def replay(self):
        with span("repro_torch.graph.replay"):
            try:
                self.graph.replay()
            except Exception as e:
                raise RuntimeError(f"CUDA graph replay of {self.name} "
                                   f"failed: {e}") from e
        for k, v in self.delta.items():
            _build.LAUNCHES[k] += v


# ---------------------------------------------------------------------------
# copies in and out of a graph's tensors
# ---------------------------------------------------------------------------

def _copy(dsts: List[torch.Tensor], srcs: List[torch.Tensor]) -> None:
    """dst[i] <- src[i], a few batched launches for many tensors: the
    foreach copy batches a list only where every pair shares one dtype and
    is contiguous (else it issues one copy per tensor), so the pairs go in
    such groups."""
    groups: Dict[tuple, tuple] = {}
    for d, s in zip(dsts, srcs):
        key = (d.dtype, s.dtype, d.is_contiguous() and s.is_contiguous())
        ds, ss = groups.setdefault(key, ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def _fresh(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def tensor_key(tree):
    """(shape, dtype, stride, device) of every tensor leaf: what a graph
    was captured for (``jax.jit`` retraces on shapes and dtypes; a graph
    must be recaptured)."""
    return tuple((tuple(t.shape), t.dtype, t.stride(), t.device)
                 for t in _leaves(tree))


# ---------------------------------------------------------------------------
# a program: one graph, or a chain of graphs in one pool
# ---------------------------------------------------------------------------

class ProgramGraph:
    """``segments`` (functions state dict -> new state dict, run in order)
    replayed from one CUDA graph each. Built by its first call; every
    call copies the state in, replays the chain and returns fresh copies
    of the outputs it wrote, and the caller's tensors for the keys it did
    not (``written``, known after the capture)."""

    def __init__(self, name: str, segments: Sequence[Callable]):
        self.name = name
        self.segments = list(segments)
        self.static: Dict[str, torch.Tensor] = {}
        self.chain: List[_Captured] = []
        self.out: Dict[str, torch.Tensor] = {}
        self.written: List[str] = []

    def __call__(self, state: Dict[str, torch.Tensor]):
        if not self.chain:
            self._capture(state)
        else:
            with span("repro_torch.graph.copy_in"):
                _copy([self.static[k] for k in state], list(state.values()))
        for g in self.chain:
            g.replay()
        with span("repro_torch.graph.copy_out"):
            fresh = {k: _fresh(self.out[k]) for k in self.written}
            _copy(list(fresh.values()), [self.out[k] for k in fresh])
        return {k: fresh[k] if k in fresh else state[k] for k in self.out}

    def copied_bytes(self) -> Dict[str, int]:
        """Bytes one call copies into the graph's static inputs ("in")
        and out of its outputs ("out")."""
        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts)
        return {"in": nbytes(self.static.values()),
                "out": nbytes(self.out[k] for k in self.written)}

    def _capture(self, state):
        self.static = {k: _fresh(v) for k, v in state.items()}
        _copy(list(self.static.values()), list(state.values()))
        st = dict(self.static)
        for seg in self.segments:                  # warm-up, thrown away
            st = seg(st)
        del st
        BACKEND.synchronize()
        pool = BACKEND.pool()
        st = dict(self.static)
        for i, seg in enumerate(self.segments):
            name = (self.name if len(self.segments) == 1
                    else f"{self.name}, segment {i} of {len(self.segments)}")
            g = _Captured(name, seg, st, pool)
            self.chain.append(g)
            st = g.out
        self.out = st
        self.written = [k for k, t in st.items()
                        if t is not self.static.get(k)]


# ---------------------------------------------------------------------------
# a step: copied inputs, held state
# ---------------------------------------------------------------------------

class StepGraph:
    """``fn(*args)`` replayed from a CUDA graph. The tensors of the
    arguments at the positions ``copied`` are copied into static buffers
    before each replay; every other argument is held: the graph reads and
    writes its tensors at the addresses they had at capture, so the caller
    updates them in place and passes the same objects again. Per key (the
    held objects and the copied tensors' shapes, dtypes and strides) the
    first call runs ``fn`` eagerly, the second captures, later calls
    replay. A result is returned as the held object where ``fn`` returned
    one, and as fresh copies of its tensors otherwise."""

    def __init__(self, fn: Callable, name: str, copied: Sequence[int]):
        self.fn = fn
        self.name = name
        self.copied = tuple(copied)
        self._graphs: Dict[tuple, object] = {}
        self.captures = 0

    def _key(self, args):
        return tuple(tensor_key(a) if i in self.copied else id(a)
                     for i, a in enumerate(args))

    def __call__(self, *args):
        key = self._key(args)
        entry = self._graphs.get(key)
        if entry is None:
            # the warm-up; the args are kept, so no held id is reused
            self._graphs[key] = ("warm", args)
            return self.fn(*args)
        if entry[0] == "warm":
            static = tuple(_map(a, _fresh) if i in self.copied else a
                           for i, a in enumerate(args))
            self._copy_in(static, args)
            g = _Captured(self.name, lambda a: self.fn(*a), static,
                          BACKEND.pool())
            self.captures += 1
            entry = self._graphs[key] = ("graph", static, g)
        else:
            self._copy_in(entry[1], args)
        _, static, g = entry
        g.replay()
        held = [a for i, a in enumerate(static) if i not in self.copied]
        with span("repro_torch.graph.copy_out"):
            return self._out(g.out, held)

    def _copy_in(self, static, args):
        with span("repro_torch.graph.copy_in"):
            dsts, srcs = [], []
            for i in self.copied:
                dsts += _leaves(static[i])
                srcs += _leaves(args[i])
            _copy(dsts, srcs)

    def _out(self, tree, held):
        if any(tree is h for h in held):
            return tree
        if isinstance(tree, torch.Tensor):
            out = _fresh(tree)
            _copy([out], [tree])
            return out
        if isinstance(tree, dict):
            return {k: self._out(v, held) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._out(v, held) for v in tree)
        return tree
