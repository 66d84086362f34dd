"""STWindow — MPI_Win analogue (paper §4.1).

A window names a set of remotely-accessible device buffers plus the signal
counters the runtime uses for epoch management:

  * data buffers: {name: (local_shape, dtype)} — each rank's exposed memory
  * "<win>.post_sig"  counter — exposure-epoch-open signals from targets
  * "<win>.comp_sig"  counter — access-epoch-complete signals from origins

Counter buffers are int32 (num_peers,) slots per rank. Every rank of the
process grid lives on ONE device: buffers carry a leading rank dimension
(R, *local), the JAX package's global layout, unsharded. Buffer dtypes
are numpy dtype names ("float32"; "bfloat16" too, see core/dtypes.py),
so lowering sizes them exactly as the JAX package does;
:func:`torch_dtype` maps them at allocation.

Double buffering (``double_buffer=True``): the window allocates ping/pong
copies of its communication buffers (``db_names``) AND of both signal
counters, so the post→put→wait chain of epoch *e+1* (pong set) never
touches the buffers epoch *e* (ping set) is still reading — the structural
prerequisite for the multi-stream overlap schedule (assign_streams).
Pong buffers are the ping name plus the ``PONG`` suffix; ``qual`` and the
``*_sig_at`` accessors resolve a (buffer, epoch-parity) pair to the right
concrete state key.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.core.dtypes import dtype_name

PONG = "__pp"       # state-key suffix of the pong (odd-parity) buffer set
PACK = "__pack"     # staging-buffer label prefix of a packed multi-buffer
#                     put descriptor (schedule.pack_puts): the contiguous
#                     buffer the group's payloads are packed into before
#                     riding one permuted copy. The staging buffer is a
#                     temporary the executors make (the concat before
#                     the copy), never allocated state.
CHUNK = "__chunk"   # staging-slice label prefix of a chunked-pipelined
#                     put (schedule.chunk_puts): each chunk's payload is
#                     a contiguous element slice of the put's logical
#                     flat payload — like PACK, a temporary, never
#                     allocated state.


@dataclass
class STWindow:
    name: str
    buffers: Dict[str, Tuple[tuple, str]]      # name -> (local_shape,
    #                                            numpy dtype name)
    group: Sequence                              # neighbor directions/peers
    # per-pattern direction algebra (repro.core.patterns.PatternTopology);
    # None falls back to component negation (the Faces convention)
    topology: object = None
    # ping/pong sets: db_names lists the data buffers that get a pong
    # copy; the signal counters are always duplicated when double_buffer
    double_buffer: bool = False
    db_names: Tuple[str, ...] = field(default_factory=tuple)

    def opposite_index(self, direction) -> int:
        """Counter slot on the TARGET rank that traffic sent in
        ``direction`` lands in — the opposite direction's group index.
        How "opposite" is computed is a pattern property: Faces negates
        component-wise, shift groups negate modulo the grid."""
        if self.topology is not None:
            return self.topology.opposite_index(direction)
        opp = tuple(-x for x in direction)
        return list(self.group).index(opp)

    @property
    def post_sig(self) -> str:
        return f"{self.name}.post_sig"

    @property
    def comp_sig(self) -> str:
        return f"{self.name}.comp_sig"

    def _phased(self, base: str, phase: int) -> str:
        if self.double_buffer and phase % 2:
            return base + PONG
        return base

    def post_sig_at(self, phase: int = 0) -> str:
        return self._phased(self.post_sig, phase)

    def comp_sig_at(self, phase: int = 0) -> str:
        return self._phased(self.comp_sig, phase)

    def counter_names(self):
        names = [self.post_sig, self.comp_sig]
        if self.double_buffer:
            names += [self.post_sig + PONG, self.comp_sig + PONG]
        return names

    def buffer_names(self):
        return list(self.buffers)

    def base_buffer(self, bname: str) -> str:
        """Strip the pong suffix off a buffer base name."""
        if bname.endswith(PONG):
            return bname[:-len(PONG)]
        return bname

    def spec_of(self, bname: str):
        """(local_shape, dtype) of a buffer base name, pong keys resolving
        to their ping buffer's spec; None when the window doesn't own it."""
        return self.buffers.get(self.base_buffer(bname))

    def pack_staging(self, epoch: int, phase: int, nbuffers: int) -> str:
        """Label of the staging buffer a packed put descriptor packs its
        ``nbuffers`` payloads into (one per (epoch, parity) group)."""
        return f"{self.name}.{PACK}{epoch}p{phase % 2}x{nbuffers}"

    def chunk_staging(self, epoch: int, phase: int, nchunks: int) -> str:
        """Label of the per-chunk staging slices a chunked put streams
        its payload through (one chain per (epoch, parity) put)."""
        return f"{self.name}.{CHUNK}{epoch}p{phase % 2}x{nchunks}"

    def state_specs(self, num_ranks: int) -> Dict[str, Tuple[tuple, str]]:
        """{state key: (global shape, numpy dtype name)} of every buffer
        and counter this window owns — what ``STStream.allocate`` makes."""
        specs = {}
        for bname, (shape, dtype) in self.buffers.items():
            spec = ((num_ranks,) + tuple(shape), dtype_name(dtype))
            specs[f"{self.name}.{bname}"] = spec
            if self.double_buffer and bname in self.db_names:
                specs[f"{self.name}.{bname}{PONG}"] = spec
        npeers = max(len(self.group), 1)
        for cname in self.counter_names():
            specs[cname] = ((num_ranks, npeers), "int32")
        return specs

    def qual(self, bname: str, phase: int = 0) -> str:
        """Qualified state key of ``bname`` for an epoch of the given
        parity; non-double-buffered names resolve to the ping key for
        every phase."""
        if self.double_buffer and phase % 2 and bname in self.db_names:
            return f"{self.name}.{bname}{PONG}"
        return f"{self.name}.{bname}"


def torch_dtype(name: str) -> torch.dtype:
    """torch dtype of a window dtype name ("float32" -> torch.float32,
    "bfloat16" -> torch.bfloat16)."""
    return getattr(torch, dtype_name(name))


def dtype_of(t: torch.Tensor) -> str:
    """The window dtype name of a tensor's dtype ("bfloat16", ...)."""
    return str(t.dtype).replace("torch.", "")
