"""Triggered-operation IR (paper §3) — the live program representation.

A NIC triggered op has (trigger_counter, threshold, completion_counter):
it executes when trigger_counter reaches threshold, and bumps its
completion counter when done. Completion observation is CHAINED (§3.2):
the payload put carries a chained signal descriptor that increments a
device-memory counter slot a wait kernel polls.

This module is the first-class program representation of the compiler
pipeline:

    STStream op queue --lower--> TriggeredProgram --schedule--> same
    TriggeredProgram with dependency edges --emit--> one of four
    consumers (compiled ST / host-orchestrated / fused progress
    engine / cost simulator).

  * stage 1: :mod:`repro_torch.core.lower` builds the descriptor DAG,
  * stage 2: :mod:`repro_torch.core.schedule` passes add throttling /
    ordering edges, fuse signal kernels, and (``fused=True``) plan
    per-stream segments,
  * stage 3: :mod:`repro_torch.core.backends` (executors),
    :mod:`repro_torch.core.engine` (device-resident progress engine), and
    :mod:`repro_torch.core.throttle` (simulator) consume the scheduled DAG.

GPU adaptation: counters are named slots in a device-resident int32
counter buffer ("win.post_sig[3]"); the "MMIO doorbell" is emission
order on one CUDA stream. Descriptors are host objects — enqueued
immediately, lowered and scheduled once, then emitted onto the device
stream without a host synchronisation until the program ends (the
offload property).

Resources are finite (§5.2): `ResourcePool` models the NIC's
triggered-op slots; the throttling passes in schedule.py decide how slot
reuse constrains the schedule. This module stays pure Python — no torch
imports — so programs can be built, transformed, and simulated off-device.
This IR is an exact copy of the JAX package's, so both packages schedule
identical programs.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

_ids = itertools.count()


def fresh_id() -> int:
    return next(_ids)


@dataclass
class TriggeredOp:
    """One descriptor node of the program DAG.

    kind:
      * "kernel"   — compute launch (fn/reads/writes)
      * "signal"   — tiny counter-bump put (role "post" or "completion")
      * "start"    — origin-side access-epoch open: snapshots the post
                     counter that triggers this epoch's puts
      * "put"      — payload put descriptor; fires its chained completion
                     signal (§3.2) when the payload lands
      * "complete" — access-epoch close marker (host backend blocks here)
      * "wait"     — target-side wait kernel polling a completion counter
    """
    kind: str
    window: str = ""
    label: str = ""
    # kernel payload
    fn: Any = None
    fn_token: int = -1              # stream-assigned monotonic identity of
    #                                 fn (id(fn) is reusable after GC and
    #                                 must never key a cache)
    reads: Tuple[str, ...] = ()
    writes: Tuple[str, ...] = ()
    # put payload
    src: Optional[str] = None
    dst: Optional[str] = None
    direction: Any = None
    nbytes: int = 0
    srcs: Tuple[str, ...] = ()      # packed multi-buffer descriptor
    #                                 (schedule.pack_puts): ALL source
    #                                 buffers riding this one put; empty
    #                                 for a plain single-buffer put
    dsts: Tuple[str, ...] = ()      # matching destination buffers
    dtype: str = ""                 # numpy dtype name of the put's source
    #                                 buffer (from lowering): packed
    #                                 members must agree so the staging
    #                                 concat is a pure byte reshuffle
    perm: Tuple = ()                # the put's full (src, dst) linear-rank
    #                                 permutation from lowering — the
    #                                 EXACT identity pack_puts groups by:
    #                                 equal perms ride one collective
    link: str = "intra"             # physical link class of a put: "intra"
    #                                 (on-node xGMI) or "inter" (off-node
    #                                 through the NIC) — from the window
    #                                 topology's node mapping at lowering
    node_deltas: Tuple[int, ...] = ()   # per-source-rank node-index delta
    #                                 vector of the put's permutation:
    #                                 equal vectors = same target node
    #                                 from EVERY rank, the coalescing key
    #                                 for node_aware_pass aggregation
    aggregated: bool = False        # tail of a coalesced same-target-node
    #                                 put group (node_aware_pass marking —
    #                                 an ordering/metadata hint; the cost
    #                                 model prices every put's alpha since
    #                                 pack_puts/chunk_puts materialize real
    #                                 aggregation)
    mcast_dirs: Tuple[Tuple[int, ...], ...] = ()   # multicast put: every
    #                                 branch direction the ONE src payload
    #                                 fans out over (dsts pairs up
    #                                 per-branch); empty = unicast. One
    #                                 descriptor, one completion tree
    #                                 counted as ONE signal at the source.
    # chunked-pipelined transport (schedule.chunk_puts): a put whose
    # payload exceeds chunk_bytes is rewritten into a chain of chunk
    # descriptors so pack(k+1)/wire(k)/unpack(k-1) overlap
    chunk_index: int = 0            # position in the chunk chain (0 = head)
    chunk_count: int = 1            # chunks of the logical put (1 = whole)
    chunk_offset: int = 0           # element offset into the logical flat
    #                                 payload (the packed concat for packed
    #                                 puts) this chunk starts at
    chunk_elems: int = 0            # element count of this chunk (0 = all)
    chunk_head: int = -1            # op_id of chunk 0 (-1 = unchunked)
    expected_puts: int = -1         # wait nodes: put count of the epoch
    #                                 this wait joins, threaded from
    #                                 lowering so the simulator can refuse
    #                                 a silent zero-completion resolve
    #                                 (-1 = unknown/hand-built: unchecked)
    epoch: int = 0
    phase: int = 0                  # ping/pong buffer parity (double-
    #                                 buffered windows): which counter/data
    #                                 buffer set this op's epoch uses
    stream: int = 0                 # device stream (assign_streams pass):
    #                                 0 = compute, >=1 = communication
    trigger_counter: str = ""       # named counter slot arming this op
    threshold: int = 1
    completion_counter: str = ""    # named counter slot bumped on completion
    # signal payload
    role: str = ""                  # "post" | "completion"
    slot: int = -1                  # target counter slot index
    slots: Tuple = ()               # fused signal: ((slot, direction), ...)
    fused: bool = False             # merged-signal-kernel (paper §5.4)
    wire: bool = True               # True: crosses the wire (second tiny
    #                                 put); False: local bump tied to the
    #                                 payload's arrival
    counter: str = ""               # counter buffer this signal/wait targets
    # schedule edges (op_ids of puts whose completion must precede firing)
    deps: Tuple[int, ...] = ()
    chained: Optional["TriggeredOp"] = None   # §3.2 chained signal
    op_id: int = field(default_factory=fresh_id)

    def structural_key(self, idx: Optional[Dict[int, int]] = None,
                       with_deps: bool = True):
        """Cache key independent of global op_id numbering: deps are
        normalized through `idx` (op_id -> position in program)."""
        deps = ()
        if with_deps and self.deps:
            deps = tuple(sorted((idx or {}).get(d, -1) for d in self.deps))
        chained = (self.chained.structural_key(idx, with_deps=False)
                   if self.chained is not None else None)
        return (self.kind, self.window, self.label, self.fn_token,
                self.reads, self.writes, self.src, self.dst,
                self.srcs, self.dsts,
                tuple(self.direction) if self.direction else None,
                self.role, self.slot, tuple(self.slots), self.fused,
                self.wire, self.counter, deps, chained,
                self.phase, self.stream, self.mcast_dirs,
                self.chunk_offset, self.chunk_elems, self.chunk_count)


@dataclass
class TriggeredProgram:
    """A lowered (and, after schedule passes, scheduled) descriptor DAG.

    `nodes` is the device emission order; `deps` edges on put nodes plus
    the §3.2 `chained` links make it a DAG. `meta` carries schedule-pass
    results (policy, resource high-water mark, merged flag)."""
    nodes: List[TriggeredOp] = field(default_factory=list)
    windows: Dict[str, Any] = field(default_factory=dict)
    meta: Dict[str, Any] = field(default_factory=dict)

    def puts(self) -> List[TriggeredOp]:
        return [n for n in self.nodes if n.kind == "put"]

    def packed_puts(self) -> List[TriggeredOp]:
        """Puts that are packed multi-buffer descriptors
        (schedule.pack_puts materialized an aggregation group)."""
        return [n for n in self.puts() if len(n.srcs) > 1]

    def chunked_puts(self) -> List[TriggeredOp]:
        """Chunk descriptors of pipelined puts (schedule.chunk_puts split
        a large payload into a chain; every chunk — head and tails —
        counts)."""
        return [n for n in self.puts() if n.chunk_count > 1]

    def multicast_puts(self) -> List[TriggeredOp]:
        """One-to-many put descriptors (one src payload, many dst ranks,
        one completion tree)."""
        return [n for n in self.puts() if n.mcast_dirs]

    def epochs(self) -> int:
        return sum(1 for n in self.nodes if n.kind == "complete")

    def key(self):
        idx = {n.op_id: i for i, n in enumerate(self.nodes)}
        return tuple(n.structural_key(idx) for n in self.nodes)

    # -- descriptor statistics (surfaced via launch/report + benchmarks) ----
    def critical_path_depth(self) -> int:
        """Longest chain of descriptors: kernels/signals/waits execute
        in-order on their assigned device stream (one per `stream` value);
        puts are offloaded and serialize only on their dependency edges;
        a wait joins the completions of its window's puts; a chained
        signal adds one hop after its put. Cross-stream dependency edges
        (assign_streams) join through the per-op depth table."""
        depth: Dict[int, int] = {}
        win_put_depth: Dict[str, int] = {}
        stream_d: Dict[int, int] = {}
        maxd = 0
        for n in self.nodes:
            base = stream_d.get(n.stream, 0)
            for dep in n.deps:
                base = max(base, depth.get(dep, 0))
            if n.kind == "put":
                d = base + 1
                if n.chained is not None:
                    d += 1
                depth[n.op_id] = d
                win_put_depth[n.window] = max(
                    win_put_depth.get(n.window, 0), d)
            elif n.kind == "wait":
                stream_d[n.stream] = max(
                    base + 1, win_put_depth.get(n.window, 0) + 1)
                depth[n.op_id] = stream_d[n.stream]
            elif n.kind in ("kernel", "signal"):
                stream_d[n.stream] = base + 1
                depth[n.op_id] = stream_d[n.stream]
            else:
                # "start"/"complete" are markers: no device work
                depth[n.op_id] = base
            maxd = max(maxd, stream_d.get(n.stream, 0),
                       depth.get(n.op_id, 0))
        return maxd

    def stats(self) -> Dict[str, Any]:
        puts = self.puts()
        epochs = max(self.epochs(), 1)
        signals = sum(1 for n in self.nodes if n.kind == "signal")
        signals += sum(1 for n in puts if n.chained is not None)
        packed = self.packed_puts()
        return {
            "descriptors": len(self.nodes),
            "puts": len(puts),
            # a packed descriptor carries several buffers on one wire
            # message: put_buffers is what the UNPACKED schedule would
            # have issued, puts is what this schedule actually issues
            "packed_puts": len(packed),
            # chunk descriptors of pipelined large puts / one-to-many
            # multicast descriptors (0 on pre-chunking schedules)
            "chunked_puts": len(self.chunked_puts()),
            "multicast_puts": len(self.multicast_puts()),
            "chunk_bytes": self.meta.get("chunk_bytes", 0),
            "put_buffers": sum(max(len(p.srcs), 1) for p in puts),
            "epochs": self.epochs(),
            "puts_per_epoch": len(puts) / epochs,
            "bytes_per_epoch": sum(p.nbytes for p in puts) / epochs,
            "signals": signals,
            "kernels": sum(1 for n in self.nodes if n.kind == "kernel"),
            "dep_edges": sum(len(n.deps) for n in puts),
            "inter_puts": sum(1 for p in puts if p.link == "inter"),
            "resource_high_water": self.meta.get("resource_high_water", 0),
            "critical_path_depth": self.critical_path_depth(),
            "throttle": self.meta.get("throttle", "none"),
            # None for unbounded policies (none/application): those
            # schedules hold no descriptor slots, so there is no real R
            "resources": self.meta.get("resources"),
            "merged": self.meta.get("merged", True),
            "pattern": self.meta.get("pattern", ""),
            "nstreams": self.meta.get("nstreams", 1),
            "double_buffer": self.meta.get("double_buffer", False),
            "node_aware": self.meta.get("node_aware", False),
            "pack": self.meta.get("pack", False),
            # device-resident progress engine (schedule.plan_segments):
            # fused schedules launch per-SEGMENT, not per-op
            "fused": bool(self.meta.get("fused", False)),
            "segments": self.meta.get("segments", 0),
        }


@dataclass
class ResourcePool:
    """Finite triggered-op descriptor slots (paper §5.2).

    `acquire` returns the op_id whose completion must precede reuse of the
    slot (None while slots are free) — the throttling pass turns that
    into a schedule dependency edge."""
    capacity: int
    in_flight: list = field(default_factory=list)
    high_water: int = 0

    def acquire(self, op_id: int) -> Optional[int]:
        blocker = None
        if len(self.in_flight) >= self.capacity:
            blocker = self.in_flight.pop(0)
        self.in_flight.append(op_id)
        self.high_water = max(self.high_water, len(self.in_flight))
        return blocker

    def release_all(self):
        self.in_flight.clear()

    def release_upto(self, op_id: int):
        self.in_flight = [o for o in self.in_flight if o > op_id]
