"""Plain NumPy reference of the Faces program (paper §6.2): the state
after k iterations of increment, 26-neighbour exchange, unpack and
per-rank max, on a periodic (px, py, pz) grid of ranks, each holding an
(nx, ny, nz) float32 block.

One iteration, as the program defines it:

  src  <- (src + 1) + (it mod 3);  it <- it + 1       (float32)
  send[d] = src's surface in direction d (C order), for the 26 d
  recv[d] at rank r = send[d] of rank r - d             (periodic)
  acc = 0; acc[surface d] += recv[d], d in DIRECTIONS order
  res = max |acc| per rank
  post and completion counters: one more per slot

A frozen copy of the exchange the repository's chip smoke script
replays (``numpy_exchange``); it imports nothing of the program.

The increment is the same float32 map for every cell, so the reference
replays it on the distinct starting values only and looks each cell up:
exact, whatever the values grow to, in a time that does not depend on
the block size.
"""
from __future__ import annotations

import itertools

import numpy as np

DIRECTIONS = [d for d in itertools.product((-1, 0, 1), repeat=3)
              if d != (0, 0, 0)]
SLOTS = len(DIRECTIONS)


def surface_slices(n, d):
    return tuple(slice(0, 1) if dd == -1 else slice(k - 1, k) if dd == 1
                 else slice(0, k) for k, dd in zip(n, d))


def key(d):
    return "".join(str(x) for x in d)


def _exact(x):
    return x


class FacesReplay:
    """Replays the program from its starting blocks ``values[index]``
    (``index``: (R, nx, ny, nz) integers into the float32 ``values``);
    ``state(k)`` gives the state after k iterations, in the program's
    names (``<window>.src`` and so on). Calls must ask for k in
    increasing order: the increment table advances in place.

    ``rounding`` is applied to the result of every addition (float32
    arithmetic as it is; a lower precision's rounding for the control)."""

    def __init__(self, index: np.ndarray, values: np.ndarray, grid,
                 window: str = "faces", rounding=_exact):
        self.grid = tuple(grid)
        self.n = tuple(index.shape[1:])
        self.window = window
        self.round = rounding
        self.index = index
        self.table = self.round(np.asarray(values, np.float32))
        self.done = 0

    @classmethod
    def from_blocks(cls, src0: np.ndarray, grid, **kw) -> "FacesReplay":
        values, index = np.unique(src0, return_inverse=True)
        return cls(index.reshape(src0.shape), values, grid, **kw)

    def _advance(self, k: int):
        if k < self.done:
            raise ValueError("FacesReplay: iterations asked out of order")
        one = np.float32(1.0)
        for it in range(self.done, k):
            self.table = self.round(self.round(self.table + one)
                                    + np.float32(it % 3))
        self.done = k

    def state(self, k: int) -> dict:
        self._advance(k)
        R = self.index.shape[0]
        src = self.table[self.index]
        g = src.reshape(self.grid + self.n)
        acc = np.zeros_like(g)
        out = {}
        for d in DIRECTIONS:
            sl = (slice(None),) * 3 + surface_slices(self.n, d)
            recv = np.roll(g[sl], shift=d, axis=(0, 1, 2))
            acc[sl] = self.round(acc[sl] + recv)
            out[f"send{key(d)}"] = g[sl].reshape(R, -1)
            out[f"recv{key(d)}"] = recv.reshape(R, -1)
        acc = acc.reshape(src.shape)
        out["src"] = src
        out["acc"] = acc
        out["res"] = np.abs(acc).reshape(R, -1).max(axis=1, keepdims=True)
        out["it"] = np.full((R, 1), k, np.float32)
        out["post_sig"] = np.full((R, SLOTS), k, np.int32)
        out["comp_sig"] = np.full((R, SLOTS), k, np.int32)
        return {f"{self.window}.{name}": v for name, v in out.items()}


def mismatches(got: dict, want: dict) -> int:
    """Elements of ``got`` (host arrays by state key) that differ from
    ``want``; a key missing on either side, or of another shape, counts
    all its elements. NaN equals nothing."""
    bad = 0
    for k in set(got) | set(want):
        a, b = got.get(k), want.get(k)
        if a is None or b is None or a.shape != b.shape:
            bad += max(0 if a is None else a.size, 0 if b is None else b.size)
            continue
        bad += int(np.count_nonzero(a != b))
    return bad
