"""Pattern-agnostic ST program constructors (registry + topology).

The paper's stream-triggered strategy is pattern-agnostic: deferred
descriptors + counter-armed triggered ops are a general communication
abstraction (companion work arXiv:2208.04817), not a halo-exchange
trick. This module makes that concrete for the repo: every transport is
an :class:`STPattern` — a function that enqueues its program on an
:class:`~repro_torch.core.stream.STStream` against a :class:`PatternTopology`
describing its neighbor group — and everything downstream (lowering,
schedule passes, the three backends, the cost simulator, descriptor
stats) is shared.

Built-in patterns (registered by their home modules on first use):

  * ``"faces"`` — 26-neighbor 3-D halo exchange (repro_torch.core.halo)
  * ``"ring"``  — ring-attention KV rotation: per ring step one
    post/compute/start/put/complete/wait epoch with the block-attention
    kernel as the overlapped launch (repro_torch.core.ring)
  * ``"a2a"``   — expert-parallel MoE combine as an aggregated-put
    access epoch: each shard's partial output is put to every peer and
    summed, replacing the psum collective (repro_torch.core.ep_a2a)
  * ``"broadcast"`` — SUMMA-style row fanout: each rank's tile goes to
    every peer of its process row, either as one MULTICAST descriptor
    or as a unicast-per-peer fanout baseline (repro_torch.core.broadcast)
  * ``"serve"`` — the serving decode step's KV mirror, sampled ids and
    MoE hidden dispatch as one access epoch per generated token
    (repro_torch.core.serve_decode)

A topology owns the *direction algebra* that stage-1 lowering needs:
which peers a window signals at post(), and which counter slot a put's
completion lands in on the target (the OPPOSITE direction's slot).
Faces negates component-wise ((1,0,-1) -> (-1,0,1)); shift groups like
the a2a all-to-all negate modulo the grid ((k,) -> (n-k,)) so the group
{1..n-1} is closed. That per-pattern choice used to be hard-coded in
``STStream.opposite_index``.

This module stays torch-free; pattern functions (which create torch kernel
closures) are imported lazily, so device-free lowering/scheduling/
simulation works anywhere.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class PatternTopology:
    """Communication-neighbor description of one window's peer group.

    ``group`` is the ordered tuple of direction tuples (counter slot k
    belongs to group[k]); ``modular_opposite`` selects the direction
    algebra: plain component negation (Faces) vs negation modulo
    ``grid_shape`` (shift groups on a periodic ring, where -k == n-k).

    ``ranks_per_node`` is the HARDWARE node mapping: consecutive linear
    ranks share a node (the paper's system: 8 GCDs per node over xGMI,
    Slingshot NICs between nodes). It makes the topology a first-class
    schedule input — lowering tags every put with its link class
    ("intra" = on-node, "inter" = crosses a node boundary for at least
    one rank pair of its permutation) so the cost model can price
    per-link alpha-beta latencies and ``node_aware_pass`` can reorder
    off-node transfers first. ``None`` means a single node (every put
    intra).
    """
    name: str
    grid_axes: Tuple[str, ...]
    group: Tuple[Tuple[int, ...], ...]
    modular_opposite: bool = False
    grid_shape: Optional[Tuple[int, ...]] = None
    ranks_per_node: Optional[int] = None

    def opposite(self, direction) -> Tuple[int, ...]:
        d = tuple(direction)
        if self.modular_opposite:
            if self.grid_shape is None:
                raise ValueError(
                    f"topology {self.name!r}: modular opposite needs "
                    "grid_shape")
            return tuple((-x) % s for x, s in zip(d, self.grid_shape))
        return tuple(-x for x in d)

    def opposite_index(self, direction) -> int:
        """Counter slot on the TARGET that direction's traffic lands in."""
        return self.group.index(self.opposite(direction))

    def node_of(self, rank: int) -> int:
        """Hardware node index of a linear rank (0 when single-node)."""
        if not self.ranks_per_node:
            return 0
        return rank // self.ranks_per_node

    def link_of(self, pairs) -> Tuple[str, Tuple[int, ...]]:
        """Link class of a put whose permutation is ``pairs`` (the
        (src, dst) linear-rank list from ``STStream.perm_for``).

        Returns ``(link, node_deltas)``: "inter" when ANY rank pair
        crosses a node boundary (that put goes through the NIC — worst
        case over the SPMD permutation), else "intra"; node_deltas is
        the PER-SOURCE-RANK node-index delta vector (ordered by source
        rank). Two puts with equal vectors target the same hardware
        node from every rank — the exactness ``node_aware_pass``
        coalescing needs (a mere set of deltas would aggregate puts
        whose per-rank targets differ)."""
        if not self.ranks_per_node:
            return "intra", ()
        deltas = tuple(self.node_of(dst) - self.node_of(src)
                       for src, dst in sorted(pairs))
        link = "inter" if any(d != 0 for d in deltas) else "intra"
        return link, deltas


def ring_topology(grid_axes=("data",),
                  ranks_per_node: Optional[int] = None) -> PatternTopology:
    """1-D double-ended ring: send +1, receive from -1."""
    return PatternTopology("ring", tuple(grid_axes), ((1,), (-1,)),
                           ranks_per_node=ranks_per_node)


def shifts_topology(n: int, grid_axes=("model",),
                    ranks_per_node: Optional[int] = None) -> PatternTopology:
    """All-to-all on a periodic 1-D grid: every nonzero shift 1..n-1.
    Opposite is modular (-k == n-k) so the group is closed."""
    return PatternTopology("shifts", tuple(grid_axes),
                           tuple((k,) for k in range(1, n)),
                           modular_opposite=True, grid_shape=(n,),
                           ranks_per_node=ranks_per_node)


def row_broadcast_topology(rows: int, cols: int, grid_axes=("row", "col"),
                           ranks_per_node: Optional[int] = None
                           ) -> PatternTopology:
    """Row fanout on a (rows, cols) grid: every nonzero column shift
    (0, k), k in 1..cols-1 — each rank reaches its whole process row.
    Opposite is modular on the column axis ((0, k) -> (0, cols-k)), so
    the group is closed; the one-to-many broadcast pattern multicasts
    over exactly this group."""
    return PatternTopology("row_broadcast", tuple(grid_axes),
                           tuple((0, k) for k in range(1, cols)),
                           modular_opposite=True, grid_shape=(rows, cols),
                           ranks_per_node=ranks_per_node)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class STPattern:
    """A registered ST program constructor.

    ``build(stream, niter, *, merged=..., host_sync_every=..., **kw)``
    enqueues ``niter`` iterations of the transport on ``stream`` and
    returns ``(window, kernels)`` — the same contract as
    ``halo.build_faces_program``.
    """
    name: str
    build: Callable
    grid_axes: Tuple[str, ...]
    default_grid: Tuple[int, ...]
    doc: str = ""


_REGISTRY: Dict[str, STPattern] = {}


def register_pattern(name: str, *, grid_axes, default_grid, doc: str = ""):
    """Decorator registering an ST program constructor under ``name``."""
    def deco(fn):
        _REGISTRY[name] = STPattern(name, fn, tuple(grid_axes),
                                    tuple(default_grid), doc)
        return fn
    return deco


def _ensure_builtins():
    # constructors live with their transports; importing registers them
    from repro_torch.core import (broadcast, ep_a2a, halo,  # noqa: F401
                                  ring, serve_decode)


def available_patterns() -> List[str]:
    _ensure_builtins()
    return sorted(_REGISTRY)


def get_pattern(name: str) -> STPattern:
    _ensure_builtins()
    if name not in _REGISTRY:
        raise KeyError(f"unknown ST pattern {name!r}; "
                       f"available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def build_pattern(stream, name: str, niter: int, **kw):
    """Enqueue ``niter`` iterations of a registered pattern on ``stream``."""
    return get_pattern(name).build(stream, niter, **kw)


# ---------------------------------------------------------------------------
# device-free programs + derived cost (shared by tests, CI, benchmarks)
# ---------------------------------------------------------------------------

def pattern_programs(name: str, niter: int, *, grid=None,
                     throttle: str = "adaptive", resources: int = 16,
                     merged: bool = True, ordered: bool = False,
                     host_sync_every: int = 0, nstreams: int = 1,
                     double_buffer: bool = False,
                     ranks_per_node: Optional[int] = None,
                     node_aware: bool = False, coalesce: bool = False,
                     pack: bool = False, chunk_bytes: int = 0,
                     fused: bool = False,
                     config=None, tuned_path: Optional[str] = None,
                     size: Optional[str] = None,
                     **build_kw):
    """Lower+schedule a pattern on a device-free stream — the same
    constructor and passes the executors use, minus a device. ``nstreams>1``
    runs the stream-assignment pass (compute stream + communication
    streams); ``double_buffer`` builds the program on ping/pong window
    buffers so alternating epochs are conflict-free. ``ranks_per_node``
    sets the hardware node mapping on the pattern topology (puts get
    intra/inter link tags); ``node_aware``/``coalesce`` run the
    node-aware schedule pass (off-node puts first, optional same-target-
    node aggregation); ``pack`` materializes off-node aggregation groups
    as packed multi-buffer put descriptors (schedule.pack_puts);
    ``chunk_bytes`` splits larger off-node puts into pipelined chunk
    chains (schedule.chunk_puts); ``fused`` marks the program for the
    device-resident progress engine and runs the segment planner
    (schedule.plan_segments) — the simulator then charges host dispatch
    per SEGMENT.

    ``config`` overrides the individual knobs above with a tuned
    :class:`~repro_torch.core.autotune.ScheduleConfig` (or its dict form) —
    including the BUILD-time knobs double_buffer and multicast. The
    string ``"auto"`` consults the tuned cache (``tuned_path`` or
    ``results/tuned_torch.json``) under the ``(name, grid,
    ranks_per_node, size)`` key, autotuning on a miss; ``size`` is the
    explicit message-size token of that key (e.g. ``"b4"``)."""
    from repro_torch.core.stream import STStream

    p = get_pattern(name)
    grid = tuple(grid) if grid is not None else p.default_grid
    if config is not None:
        from repro_torch.core.autotune import resolve_config
        cfg = resolve_config(config, name, grid=grid,
                             ranks_per_node=ranks_per_node, size=size,
                             path=tuned_path, **build_kw)
        throttle, resources = cfg.throttle, cfg.resources
        merged, ordered = cfg.merged, cfg.ordered
        nstreams, node_aware = cfg.nstreams, cfg.node_aware
        coalesce, pack = cfg.coalesce, cfg.pack
        chunk_bytes = cfg.chunk_bytes
        double_buffer = cfg.double_buffer
        fused = cfg.fused
        if cfg.multicast is not None:
            build_kw = dict(build_kw, multicast=cfg.multicast)
    stream = STStream(None, p.grid_axes, grid_shape=grid)
    p.build(stream, niter, merged=merged, host_sync_every=host_sync_every,
            double_buffer=double_buffer, ranks_per_node=ranks_per_node,
            **build_kw)
    progs = stream.scheduled_programs(throttle=throttle,
                                      resources=resources,
                                      merged=merged, ordered=ordered,
                                      nstreams=nstreams,
                                      node_aware=node_aware,
                                      coalesce=coalesce, pack=pack,
                                      chunk_bytes=chunk_bytes,
                                      fused=fused)
    if config is not None:
        for prog in progs:
            prog.meta["config"] = cfg.to_dict()
    return progs


def simulate_pattern(name: str, niter: int, *, policy: str = "adaptive",
                     resources: int = 16, merged: bool = True,
                     ordered: bool = False, host_orchestrated: bool = False,
                     cm=None, grid=None, nstreams: int = 1,
                     double_buffer: bool = False,
                     ranks_per_node: Optional[int] = None,
                     node_aware: bool = False, coalesce: bool = False,
                     pack: bool = False, chunk_bytes: int = 0,
                     fused: bool = False,
                     config=None, tuned_path: Optional[str] = None,
                     size: Optional[str] = None,
                     **build_kw) -> float:
    """Derived critical-path time of ``niter`` pattern iterations.

    ``policy="application"`` (§5.2.1) splits the program every iteration
    and keeps the runtime's static weak-sync edges, so the Fig. 13
    ordering adaptive <= static <= application holds structurally.
    ``nstreams``/``double_buffer`` select the overlapped multi-stream
    schedule (the simulator walks one timeline per stream).
    ``ranks_per_node`` prices off-node puts on the inter-node link (with
    serialized NIC injection); ``node_aware``/``coalesce`` apply the
    node-aware ordering pass; ``pack`` materializes off-node aggregation
    groups as packed multi-buffer descriptors (one alpha + summed beta +
    one NIC injection per group); ``chunk_bytes`` splits larger off-node
    puts into pipelined chunk chains (per-chunk beta, first-chunk-only
    alpha). ``cm`` is a :class:`~repro_torch.core.throttle.CostModel`
    (the default constants when None); ``cm="calibrated"`` prices with
    the measured-constants model from ``results/calibration.json``
    (seed constants when no calibration exists;
    :func:`~repro_torch.core.calibrate.calibrated_cost_model`).

    ``config`` overrides the schedule/build knobs with a tuned
    :class:`~repro_torch.core.autotune.ScheduleConfig` (``"auto"``
    consults the tuned cache — see :func:`pattern_programs`); a config
    wins over ``policy`` for the throttle choice."""
    from repro_torch.core.throttle import simulate_pipeline

    if cm == "calibrated":
        from repro_torch.core.calibrate import calibrated_cost_model
        cm = calibrated_cost_model()

    host_sync_every = 1 if policy == "application" else 0
    throttle = "static" if policy == "application" else policy
    progs = pattern_programs(name, niter, grid=grid, throttle=throttle,
                             resources=resources, merged=merged,
                             ordered=ordered,
                             host_sync_every=host_sync_every,
                             nstreams=nstreams, double_buffer=double_buffer,
                             ranks_per_node=ranks_per_node,
                             node_aware=node_aware, coalesce=coalesce,
                             pack=pack, chunk_bytes=chunk_bytes,
                             fused=fused, config=config,
                             tuned_path=tuned_path, size=size, **build_kw)
    return simulate_pipeline(progs, cm, host_orchestrated)
