"""Deterministic synthetic token pipeline: the port's copy of the JAX
package's ``data/pipeline.py`` (numpy only, so its batches are bit for
bit the reference's for every (seed, step, host)).

Production layout: each host generates only ITS shard of the global batch
(host-local batch = global_batch / num_hosts), determinism is keyed by
(seed, step, host), and a background prefetch thread keeps `prefetch`
batches ahead so the input pipeline is off the step path. On one CPU
process this degenerates to a single "host" but the sharding math and the
prefetch machinery are the ones a multi-host deployment uses.

The synthetic distribution is a mixture of Zipf-like unigram draws and
short repeated motifs, so losses are learnable (motifs) and well-behaved.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    motif_len: int = 8
    motif_count: int = 64

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.num_hosts} hosts")
        rng = np.random.RandomState(self.seed)
        self.motifs = rng.randint(
            2, self.vocab_size, size=(self.motif_count, self.motif_len))
        # Zipf-ish unigram distribution
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self.unigram = p / p.sum()

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.num_hosts

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for (seed, step, host)."""
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 131 + self.host_id) % (2**31))
        B, S = self.host_batch, self.seq_len
        toks = rng.choice(self.vocab_size, size=(B, S + 1),
                          p=self.unigram).astype(np.int32)
        # plant motifs (learnable structure); skip if sequences are too
        # short to hold one
        if S > self.motif_len:
            n_motif = max(1, S // (4 * self.motif_len))
            for b in range(B):
                for _ in range(n_motif):
                    m = self.motifs[rng.randint(self.motif_count)]
                    pos = rng.randint(0, S - self.motif_len)
                    toks[b, pos:pos + self.motif_len] = m
        return {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:].copy(),
            "positions": np.broadcast_to(np.arange(S, dtype=np.int32),
                                         (B, S)).copy(),
        }


def make_batch_iterator(ds: SyntheticTokens, start_step: int = 0,
                        prefetch: int = 2) -> Iterator[dict]:
    """Background-threaded prefetching iterator (resumable at start_step)."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    err: list = []

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                batch = ds.batch_at(step)
            except BaseException as e:   # surface worker crashes to caller
                err.append(e)
                return
            while not stop.is_set():
                try:
                    q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue
            step += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            while True:
                if err:
                    raise RuntimeError("data worker failed") from err[0]
                try:
                    return q.get(timeout=1.0)
                except queue.Empty:
                    continue

        def close(self):
            stop.set()

    return _Iter()
