"""STStream — the stream-triggered deferred execution queue (paper §2, §4).

The host *enqueues* operations (post / start / put / complete / wait /
kernel launches) and returns immediately; nothing executes until
``synchronize``. Execution is a three-stage pipeline over the
triggered-op IR (repro_torch.core.triggered):

    enqueue API --(1) lower.py--> TriggeredProgram DAG
                --(2) schedule.py passes--> scheduled DAG (+dep edges)
                --(3) backends.py / engine.py / throttle.py--> one of
                      four emitters

Stage-3 emitters all consume the SAME scheduled DAG:

  * mode="st"   (Fig. 9b): the WHOLE queue (all iterations) is one CUDA
    graph, captured at its first run and replayed with no host
    round-trip; ``synchronize`` is the single host sync at the end.

  * mode="host" (Fig. 9a): one dispatch per descriptor with the host
    blocking at every epoch boundary — the CPU-orchestrated standard
    active-RMA baseline, eager on the card too.

  * mode="fused": the progress engine (core/engine.py) — the schedule
    is planned into per-stream segments, one CUDA graph each, and the
    host launches one graph per segment.

  * the cost simulator (core/throttle.py) walks the identical schedule.

Every rank of the process grid lives on one device (``device``), in
state tensors with a leading rank dim; ``device=None`` (with an explicit
``grid_shape``) builds a device-free stream whose programs can be
lowered, scheduled, and simulated but not executed. On the CPU the st
and fused emitters run eagerly (:mod:`repro_torch.core.graphs` replays
graphs on CUDA devices only). The graphs are cached on the stream and
hold their memory while it lives (:meth:`STStream.clear_graphs`).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import backends, engine
from repro_torch.core.compat import block, resolve_device
from repro_torch.core.lower import lower_segment, split_segments
from repro_torch.core.schedule import schedule
from repro_torch.core.spans import span
from repro_torch.core.triggered import TriggeredProgram
from repro_torch.core.window import STWindow, torch_dtype


@dataclass
class _Op:
    """Raw enqueue-API record; lowered onto the triggered-op IR."""
    kind: str
    window: Optional[STWindow] = None
    fn: Optional[Callable] = None
    # monotonic per-stream identity of fn, assigned at launch(): id(fn)
    # can be reused by a fresh closure after the old one is collected,
    # which would silently hit a stale program graph (the graph caches
    # key on TriggeredProgram.key(), which carries the token)
    fn_token: int = -1
    reads: Tuple[str, ...] = ()
    writes: Tuple[str, ...] = ()
    put: Optional[dict] = None
    phase: int = 0            # ping/pong parity (double-buffered windows)
    label: str = ""


class STStream:
    """Deferred op queue over a process grid held on one device.

    ``device`` is ``"cuda"`` (the default; raises when no card is
    available), ``"cpu"`` (the plain PyTorch path, for tests), or
    ``None`` for a device-free stream. ``grid_shape`` gives the process
    grid over ``grid_axes``.
    """

    def __init__(self, device="cuda", grid_axes: Sequence[str] = ("x", "y",
                                                                 "z"),
                 periodic: bool = True,
                 grid_shape: Optional[Sequence[int]] = None):
        self.device = resolve_device(device)
        self.grid_axes = tuple(grid_axes)
        if grid_shape is None:
            raise ValueError("grid_shape is required")
        self.grid_shape = tuple(int(g) for g in grid_shape)
        if len(self.grid_shape) != len(self.grid_axes):
            raise ValueError(f"grid_shape {self.grid_shape} does not match "
                             f"grid_axes {self.grid_axes}")
        self.num_ranks = int(np.prod(self.grid_shape))
        self.periodic = periodic
        self.pattern = ""          # set by pattern constructors; flows into
        #                            program meta
        self._ops: List[_Op] = []
        # bumped by every enqueue (_enqueue); the queue only grows, so a
        # version names one queue and the schedule cache keys on it
        # instead of on the queued ops
        self._version = 0
        self.windows: Dict[str, STWindow] = {}
        self.dispatches = 0        # the simulator's dispatch units the
        #                            executors counted (see backends /
        #                            engine); not device launches
        # scheduled_programs calls served by the schedule cache, and those
        # that lowered and scheduled the queue
        self.schedule_hits = 0
        self.schedule_builds = 0
        self._perm_cache: Dict[tuple, list] = {}
        self._sched_cache: Dict[tuple, List[TriggeredProgram]] = {}
        # state_specs()'s keys, until create_window adds a window
        self._state_keys: Optional[frozenset] = None
        self._device_tables: Dict[tuple, object] = {}
        # the CUDA graphs of st and fused programs (core/graphs.py), by
        # program and state layout; they hold their static inputs and
        # memory pools until clear_graphs() or the stream is dropped (a
        # graph refers to its stream weakly)
        self._compiled_cache: Dict[tuple, object] = {}
        self._fused_cache: Dict[tuple, object] = {}
        self._program_keys: Dict[int, tuple] = {}
        # fn identity tokens: keyed by the function OBJECT (a strong ref,
        # so a collected closure can never alias a live token) and drawn
        # from a never-reset monotonic counter
        self._fn_tokens: Dict[Callable, int] = {}
        self._fn_token_counter = itertools.count()

    def clear_graphs(self) -> None:
        """Drop the captured program graphs and the device memory they
        hold; the next run of a program captures it again."""
        self._compiled_cache.clear()
        self._fused_cache.clear()
        self._program_keys.clear()

    # -- window management --------------------------------------------------
    def create_window(self, name, buffers, group, topology=None,
                      double_buffer=False, db_names=()) -> STWindow:
        win = STWindow(name=name, buffers=buffers, group=list(group),
                       topology=topology, double_buffer=double_buffer,
                       db_names=tuple(db_names))
        self.windows[name] = win
        self._state_keys = None
        return win

    def state_specs(self) -> Dict[str, Tuple[tuple, str]]:
        """{state key: (global shape, numpy dtype name)} of every window."""
        specs: Dict[str, Tuple[tuple, str]] = {}
        for win in self.windows.values():
            specs.update(win.state_specs(self.num_ranks))
        return specs

    def allocate(self, init: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
        """Zeroed state of every window on the stream's device, except the
        keys of ``init``, which are taken as given (held, not copied: a
        view of a model's weights stays a view). Also builds the device
        tables emission reads (put index tensors, counter updates), so no
        host-to-device copy happens later."""
        if self.device is None:
            raise ValueError("cannot allocate on a device-free stream "
                             "(constructed with device=None)")
        init = dict(init or {})
        specs = self.state_specs()
        state = {}
        for k, (shape, dtype) in specs.items():
            t = init.pop(k, None)
            if t is None:
                t = torch.zeros(shape, dtype=torch_dtype(dtype),
                                device=self.device)
            elif (tuple(t.shape) != shape or t.dtype != torch_dtype(dtype)
                  or t.device != self.device):
                raise ValueError(
                    f"allocate: init[{k!r}] is {tuple(t.shape)} {t.dtype} "
                    f"on {t.device}, the window's {shape} {dtype} on "
                    f"{self.device}")
            state[k] = t
        if init:
            raise ValueError(f"allocate: no state key {sorted(init)[:6]}")
        engine.prepare_tables(self)
        return state

    # -- enqueue API (returns immediately: deferred execution) ---------------
    @property
    def program(self) -> Tuple[_Op, ...]:
        """The enqueued ops in order; read-only, since only an enqueue
        (which bumps the queue's version) may change the queue."""
        return tuple(self._ops)

    def _enqueue(self, op: _Op) -> None:
        self._ops.append(op)
        self._version += 1

    def launch(self, fn, reads, writes, label="kernel"):
        tok = self._fn_tokens.get(fn)
        if tok is None:
            tok = self._fn_tokens[fn] = next(self._fn_token_counter)
        self._enqueue(_Op("kernel", fn=fn, fn_token=tok,
                          reads=tuple(reads), writes=tuple(writes),
                          label=label))

    def post(self, win: STWindow, phase: int = 0):
        self._enqueue(_Op("post", window=win, phase=phase))

    def start(self, win: STWindow, mode: str = "MPIX_MODE_STREAM",
              phase: int = 0):
        self._enqueue(_Op("start", window=win, phase=phase, label=mode))

    def put(self, win: STWindow, src: str, dst: str, direction,
            phase: int = 0):
        self._enqueue(_Op("put", window=win, phase=phase,
                          put=dict(src=src, dst=dst,
                                   direction=tuple(direction))))

    def put_multicast(self, win: STWindow, src: str, dsts, directions,
                      phase: int = 0):
        """One-to-many put: ONE source payload fans out to the rank in
        each of ``directions``, landing in the matching buffer of
        ``dsts`` — lowered to a single multicast descriptor with one
        completion tree (counted as one signal at the source), versus
        ``len(directions)`` unicast puts."""
        if len(dsts) != len(directions):
            raise ValueError("put_multicast: dsts and directions must "
                             "pair up per branch")
        self._enqueue(_Op(
            "put", window=win, phase=phase,
            put=dict(src=src, dsts=tuple(dsts),
                     directions=tuple(tuple(d) for d in directions))))

    def complete(self, win: STWindow, phase: int = 0):
        self._enqueue(_Op("complete", window=win, phase=phase))

    def wait(self, win: STWindow, phase: int = 0):
        self._enqueue(_Op("wait", window=win, phase=phase))

    def host_sync(self):
        """Application-level throttling point (paper §5.2.1)."""
        self._enqueue(_Op("hostsync"))

    # -- neighbor permutation -------------------------------------------------
    def rank_strides(self) -> tuple:
        """Row-major strides of the grid-coordinate -> linear-rank map.
        The SINGLE definition of rank linearization."""
        strides, acc = [], 1
        for n in reversed(self.grid_shape):
            strides.append(acc)
            acc *= n
        return tuple(reversed(strides))

    def perm_for(self, direction: tuple) -> list:
        """(src, dst) linear-rank pairs of traffic sent in ``direction``;
        on a non-periodic grid, pairs leaving the grid are dropped."""
        if direction in self._perm_cache:
            return self._perm_cache[direction]
        dims = self.grid_shape
        nd = len(dims)
        d = tuple(direction) + (0,) * (nd - len(direction))
        strides = self.rank_strides()

        def lin(coord):
            return sum((c % n) * s
                       for c, n, s in zip(coord, dims, strides))

        pairs = []
        for src in np.ndindex(*dims):
            dst = tuple((src[i] + d[i]) % dims[i] for i in range(nd))
            if not self.periodic:
                ok = all(0 <= src[i] + d[i] < dims[i] for i in range(nd))
                if not ok:
                    continue
            pairs.append((lin(src), lin(dst)))
        self._perm_cache[direction] = pairs
        return pairs

    # -- compile pipeline: lower (1) + schedule (2) ---------------------------
    def scheduled_programs(self, *, throttle: str = "adaptive",
                           resources: int = 64, merged: bool = True,
                           ordered: bool = False, nstreams: int = 1,
                           node_aware: bool = False,
                           coalesce: bool = False,
                           pack: bool = False,
                           chunk_bytes: int = 0,
                           fused: bool = False,
                           config=None) -> List[TriggeredProgram]:
        """Lower the op queue and run the schedule passes; one scheduled
        descriptor DAG per host_sync-delimited segment. Cached per
        (queue version, options), so a repeated call returns the same
        program objects without reading the queue (``schedule_hits``)
        and an enqueue since the last call lowers the queue anew
        (``schedule_builds``).

        ``config`` (a :class:`repro_torch.core.autotune.ScheduleConfig`
        or its dict form) expands into the schedule-pass knobs above
        BEFORE the cache key is computed, so a tuned config and its
        spelled-out kwargs share one cache entry. Build-time knobs the
        config may carry (double_buffer, multicast) are ignored here —
        the queue is already built; rebuild via
        ``pattern_programs(config=...)`` to apply those. The string
        ``"auto"`` is rejected: a raw stream does not know its (pattern,
        topology, size) cache key — resolve it with
        ``repro_torch.core.autotune.tuned_config`` or
        ``pattern_programs(config="auto")`` instead."""
        if config is not None:
            from repro_torch.core.autotune import ScheduleConfig
            if isinstance(config, str):
                raise ValueError(
                    "scheduled_programs(config='auto') is ambiguous on a "
                    "raw stream (no pattern/topology/size key); resolve "
                    "it via repro_torch.core.autotune.tuned_config or "
                    "pattern_programs(config='auto')")
            if isinstance(config, dict):
                config = ScheduleConfig.from_dict(config)
            return self.scheduled_programs(**config.sched_kwargs())
        key = (self._version, throttle, resources, merged, ordered,
               nstreams, node_aware, coalesce, pack, chunk_bytes, fused)
        progs = self._sched_cache.get(key)
        if progs is not None:
            self.schedule_hits += 1
            return progs
        self.schedule_builds += 1
        progs = self._sched_cache[key] = [
            schedule(lower_segment(self, seg), throttle=throttle,
                     resources=resources, merged=merged,
                     ordered=ordered, nstreams=nstreams,
                     node_aware=node_aware, coalesce=coalesce,
                     pack=pack, chunk_bytes=chunk_bytes, fused=fused)
            for seg in split_segments(self._ops)]
        return progs

    # -- execution: emit (3) --------------------------------------------------
    def synchronize(self, state, mode: str = "st", throttle: str = "adaptive",
                    resources: int = 64, merged: bool = True,
                    ordered: bool = False, nstreams: int = 1,
                    node_aware: bool = False, coalesce: bool = False,
                    pack: bool = False, chunk_bytes: int = 0,
                    fused: bool = False, config=None):
        """Execute the enqueued program; returns the new state dict (the
        one passed in is never modified).

        mode="st": the program replayed as one CUDA graph (captured at
        its first run), one host sync (at the end of this call).
        mode="host": per-descriptor dispatch, blocking at epoch
        boundaries. mode="fused": the progress engine — one graph per
        planned segment (``fused=True`` scheduling is implied). The
        returned tensors are the caller's: a later call does not change
        them. ``pack`` and ``chunk_bytes`` select packed and chunked put
        descriptors (schedule.pack_puts / schedule.chunk_puts).
        ``config`` expands a tuned
        :class:`~repro_torch.core.autotune.ScheduleConfig` into the
        schedule knobs (see :meth:`scheduled_programs`)."""
        with span("repro_torch.st.sync"):
            with span("repro_torch.st.lookup"):
                progs = self._checked_programs(
                    state, mode, throttle=throttle, resources=resources,
                    merged=merged, ordered=ordered, nstreams=nstreams,
                    node_aware=node_aware, coalesce=coalesce, pack=pack,
                    chunk_bytes=chunk_bytes,
                    fused=fused or mode == "fused", config=config)
            for prog in progs:
                if mode == "fused":
                    state = engine.run_fused(self, prog, state)
                elif mode == "st":
                    state = backends.run_compiled(self, prog, state)
                else:
                    state = backends.run_host(self, prog, state)
                # application-level sync between segments, and the single
                # host sync at the end of an ST program
                with span("repro_torch.st.block"):
                    block(self.device)
        return state

    def _checked_programs(self, state, mode, **sched_kw):
        """The scheduled programs of a synchronize call, once its
        arguments are checked against the stream."""
        if self.device is None:
            raise ValueError("cannot execute a device-free stream "
                             "(constructed with device=None)")
        if mode not in ("st", "host", "fused"):
            raise ValueError(f"unknown mode {mode!r}; expected st, host "
                             "or fused")
        keys = self._state_keys
        if keys is None:
            keys = self._state_keys = frozenset(self.state_specs())
        if state.keys() != keys:
            raise ValueError("state keys differ from the windows': "
                             f"{sorted(set(state) ^ keys)[:6]}")
        for k, v in state.items():
            if v.device != self.device:
                raise ValueError(f"state[{k!r}] is on {v.device}, the "
                                 f"stream on {self.device}")
        return self.scheduled_programs(**sched_kw)


def counters_expected(niter: int, npeers: int):
    """After n iterations of post/complete, every signal slot == n."""
    return niter * np.ones((npeers,), np.int32)
