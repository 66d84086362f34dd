"""Faces cells: the paper's 26-neighbour halo exchange (§6.2) through
the program's ST entry, ``STStream.synchronize``.

Set-up builds the program (``iterations_per_program`` merged
iterations), makes the starting blocks on the device from the seed
(integers drawn uniformly from the mix's ``initial_values``, held as
float32: every sum the program forms is then exact, whatever order it
adds in), and runs ``warmup_programs`` programs (the first captures the
CUDA graph). The window runs programs back to back, each call ending in
its host sync, each taking the state the previous one returned, until
``seconds`` have passed.

Correctness: the final state and ``check_states`` states drawn from the
window by the seed (reservoir sampling over its programs) are compared,
every element of every buffer, with the plain replay
(``stbench/reference/faces.py``) after as many iterations.
``mismatches`` counts the elements that differ; its limit is 0.

``rec`` keys: ``setup_s``, ``window_s``, ``programs`` (in the window),
``iterations_per_program``; traced runs add ``traced_programs`` and
``kernels`` ({group: {"names", "launches_per_iteration",
"bound_s_per_iteration"}}, the halo and put kernels).
"""
from __future__ import annotations

import time
from math import prod

import numpy as np

from stbench import counts
from stbench.harness import Record
from stbench.reference.faces import FacesReplay, mismatches

KERNELS = {"halo": ("halo_pack_kernel", "unpack_kernel"),
           "put": ("put_signal_kernel", "bump_kernel")}


def run(ctx) -> Record:
    import torch
    from repro_torch.core import halo
    from repro_torch.core.stream import STStream
    from stbench.devtrace import Trace

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    grid, n = tuple(cfg["grid"]), tuple(mix["n"])
    niter, R = cfg["iterations_per_program"], prod(cfg["grid"])
    stream = STStream(dev, ("x", "y", "z"), grid_shape=grid)
    win, _ = halo.build_faces_program(stream, n, niter,
                                      merged=cfg["merged"])
    state = stream.allocate()
    lo, hi = mix["initial_values"]["integers"]
    gen = torch.Generator(device=dev).manual_seed(ctx.seed % (1 << 63))
    draws = torch.randint(lo, hi, (R,) + n, generator=gen, device=dev,
                          dtype=torch.int32)
    state[win.qual("src")] = draws.float()
    index = (draws - lo).cpu().numpy()
    del draws

    def program(s):
        return stream.synchronize(s, mode=cfg["executor"],
                                  throttle=cfg["throttle"],
                                  resources=cfg["resources"],
                                  merged=cfg["merged"])

    done = 0
    for _ in range(cfg["warmup_programs"]):
        state = program(state)
        done += 1
    keep = mix["check_states"]
    rng = np.random.default_rng([ctx.seed % (1 << 63), 4])
    kept = []
    tracer = Trace(dev) if ctx.trace else None
    if tracer:
        tracer.warm()
    traced_from = traced = None
    programs = 0
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    while True:
        if tracer and traced_from is None and \
                time.perf_counter() - t0 >= mix["trace_after_s"]:
            tracer.start()
            traced_from = programs
        state = program(state)
        programs += 1
        done += 1
        if len(kept) < keep:
            kept.append((done, state))
        elif (j := rng.integers(0, programs)) < keep:
            kept[j] = (done, state)
        if traced_from is not None and traced is None and \
                programs - traced_from == mix["trace_programs"]:
            tracer.stop()
            traced = programs - traced_from
        now = time.perf_counter()
        if now - t0 >= ctx.seconds:
            break
    window_s = now - t0
    if tracer and traced is None:
        if traced_from is None:
            raise RuntimeError("faces: the window closed before the trace "
                               "began; lengthen --seconds")
        tracer.stop()
        traced = programs - traced_from
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    red = tracer.reduce() if tracer else None

    # the reference, once the program's buffers are on the host and freed
    checks = sorted({k: s for k, s in kept + [(done, state)]}.items())
    del state, kept
    replay = FacesReplay(index, np.arange(lo, hi, dtype=np.float32), grid,
                         window=win.name)
    bad = 0
    for k, s in checks:
        got = {key: v.cpu().numpy() for key, v in s.items()}
        want = replay.state(k * niter)
        bad += mismatches({key: got.get(key) for key in want}, want)
    del checks, s
    stream.clear_graphs()

    rec = {"setup_s": setup_s, "window_s": window_s, "programs": programs,
           "iterations_per_program": niter}
    if tracer:
        bounds = counts.faces_iteration_bounds(R, n)
        launches = {"halo": 2, "put": len(counts.DIRECTIONS) + 1}
        rec["traced_programs"] = traced
        rec["kernels"] = {g: {"names": KERNELS[g],
                              "launches_per_iteration": launches[g],
                              "bound_s_per_iteration": bounds[g]}
                          for g in KERNELS}
    return Record(rec=rec, checks={"mismatches": bad}, attempted=programs,
                  failed=0, memory_peak_bytes=int(peak), trace=red,
                  extra={"index": index, "values": np.arange(lo, hi),
                         "iterations": done * niter, "grid": grid,
                         "window": win.name})
