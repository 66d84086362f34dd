"""Fault-tolerance runtime: checkpoint/restart, straggler detection,
heartbeats, elastic re-mesh, preemption-safe training loop. The
port's copy of the JAX package's ``runtime/ft.py``, pure Python over
the port's checkpointer (restores take a ``device`` where the
reference's take shardings).

At 1000+ nodes the failure model is: hosts die (heartbeat timeout), chips
slow down (straggler EWMA), and preemption notices arrive (SIGTERM). The
runtime turns all three into one of two actions: SAVE+EXIT (restartable)
or RESHARD (elastic). On a single host the detectors run
against injected timings/heartbeats (unit-tested); the loop logic is the
deployable part.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from repro_torch.checkpoint import Checkpointer


@dataclass
class StragglerDetector:
    """Per-host step-time EWMA; flags hosts whose step time exceeds
    `ratio` x the fleet median EWMA for `patience` consecutive steps."""
    alpha: float = 0.2
    ratio: float = 1.8
    patience: int = 3
    ewma: Dict[int, float] = field(default_factory=dict)
    strikes: Dict[int, int] = field(default_factory=dict)

    def observe(self, host_times: Dict[int, float]) -> list:
        import statistics
        for h, t in host_times.items():
            prev = self.ewma.get(h, t)
            self.ewma[h] = (1 - self.alpha) * prev + self.alpha * t
        med = statistics.median(self.ewma.values())
        flagged = []
        for h, e in self.ewma.items():
            if med > 0 and e > self.ratio * med:
                self.strikes[h] = self.strikes.get(h, 0) + 1
                if self.strikes[h] >= self.patience:
                    flagged.append(h)
            else:
                self.strikes[h] = 0
        return flagged


@dataclass
class HeartbeatMonitor:
    """Host liveness from heartbeat timestamps."""
    timeout_s: float = 60.0
    last: Dict[int, float] = field(default_factory=dict)

    def beat(self, host: int, now: Optional[float] = None):
        self.last[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> list:
        now = time.monotonic() if now is None else now
        return [h for h, t in self.last.items() if now - t > self.timeout_s]


class TrainingRuntime:
    """Preemption-safe training loop.

    run() executes `step_fn(state, batch) -> (state, metrics)` in a loop:
      * checkpoints every `ckpt_every` steps (async, two-phase commit)
      * checkpoints + exits cleanly on SIGTERM/SIGINT (preemption)
      * on restart, resumes from the latest complete checkpoint
      * straggler/dead-host flags trigger the `on_remesh` callback (in a
        real deployment: rebuild the mesh without the bad host and restore
        the checkpoint; a restore onto another device is tested in
        tests/test_torch_checkpoint.py)
    """

    def __init__(self, ckpt_dir: str, ckpt_every: int = 50, keep: int = 3,
                 on_remesh: Optional[Callable] = None,
                 install_signal_handlers: bool = False):
        self.ckpt = Checkpointer(ckpt_dir, keep=keep)
        self.ckpt_every = ckpt_every
        self.on_remesh = on_remesh
        self.straggler = StragglerDetector()
        self.heartbeats = HeartbeatMonitor()
        self._preempted = False
        if install_signal_handlers:
            signal.signal(signal.SIGTERM, self._handle)
            signal.signal(signal.SIGINT, self._handle)

    def _handle(self, signum, frame):
        self._preempted = True

    def maybe_restore(self, state_like, device=None):
        try:
            state, step, extra = self.ckpt.restore(state_like, device)
            return state, step + 1, extra
        except FileNotFoundError:
            return state_like, 0, {}

    def run(self, state, batch_iter, step_fn, *, start_step: int = 0,
            total_steps: int = 100, log_every: int = 10,
            host_times_fn: Optional[Callable] = None,
            log_fn: Callable = print):
        step = start_step
        metrics = {}
        while step < total_steps:
            t0 = time.monotonic()
            batch = next(batch_iter)
            state, metrics = step_fn(state, batch)
            dt = time.monotonic() - t0

            if host_times_fn is not None:
                flagged = self.straggler.observe(host_times_fn(step, dt))
                if flagged and self.on_remesh is not None:
                    log_fn(f"[ft] stragglers {flagged}; requesting re-mesh")
                    self.ckpt.save(step, state, {"reason": "remesh"})
                    self.ckpt.wait()
                    self.on_remesh(flagged)

            if step % log_every == 0:
                log_fn(f"step {step} dt={dt*1e3:.1f}ms " +
                       " ".join(f"{k}={float(v):.4f}"
                                for k, v in metrics.items()
                                if hasattr(v, "__float__")))
            if self.ckpt_every and step and step % self.ckpt_every == 0:
                self.ckpt.save(step, state, {"reason": "periodic"})
            if self._preempted:
                log_fn(f"[ft] preempted at step {step}: saving and exiting")
                self.ckpt.save(step, state, {"reason": "preempt"})
                self.ckpt.wait()
                return state, step, True
            step += 1
        self.ckpt.save(total_steps - 1, state, {"reason": "final"})
        self.ckpt.wait()
        return state, step, False
