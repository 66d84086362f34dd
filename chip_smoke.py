#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's main path — the Faces 26-neighbour halo exchange
through ``repro_torch``'s ST, host and fused executors — and its three
hand-written CUDA kernels (merged halo pack, merged halo unpack, counter
bump). Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure exits non-zero):

  1. build    — nvcc builds every kernel library from ``src/repro_torch/
                 csrc`` into ``build/repro_torch/`` (seconds, ptxas report);
  2. kernels  — each kernel against its plain PyTorch version on the card,
                 exact equality, at n=(64,64,64) and n=(6,5,4), R=64;
  3. parity   — grid (2,2,2), n=(4,4,4), 3 iterations: ST x {adaptive,
                 static, none} x {merged, unmerged}, host x {merged,
                 unmerged}, fused, and packed (+ chunked) put schedules
                 on two nodes of four ranks; each against a numpy replay
                 of Faces with every post-counter slot (and, unpacked,
                 every completion slot) equal to the iteration count;
  4. full     — grid (4,4,4) = 64 ranks, n=(64,64,64) float32, 20
                 iterations in ST, host and fused modes: counters, bit-
                 identical state across modes, the last exchange against a
                 numpy exchange of the final blocks, every kernel launched
                 in every mode, and the ST and fused emission under
                 ``torch.cuda.set_sync_debug_mode("error")`` (no hidden host
                 synchronisation);
  5. timing   — CUDA-event medians: per-iteration ms of each mode; from
                 torch.profiler (full tables in ``chiprun_out/``) the
                 device's busy time and idle share and the device ops
                 and host launch calls per iteration, beside the cost
                 simulator's dispatch units; each kernel's device time
                 (CUDA-graph replay) and eager call time beside its
                 bound, its plain version and the one-call PyTorch
                 yardstick (index_select, index_add, add).

The last three lines are the kernels JSON, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Without a CUDA card the
script exits non-zero before printing any result.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
GRID_SMALL, N_SMALL, NITER_SMALL = (2, 2, 2), (4, 4, 4), 3
GRID_FULL, N_FULL, NITER_FULL = (4, 4, 4), (64, 64, 64), 20
AXES = ("x", "y", "z")
MODES = ("st", "host", "fused")
OUT_DIR = os.path.join(ROOT, "chiprun_out")     # long outputs (profiles)


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# numpy references
# ---------------------------------------------------------------------------

def numpy_oracle(halo, src0, grid=GRID_SMALL, n=N_SMALL, niter=NITER_SMALL):
    """src0: (R, nx,ny,nz) initial blocks. Replays ``niter`` iterations
    (the replay of scripts/dev_faces.py)."""
    px, py, pz = grid
    src = src0.copy()
    acc = None
    for it in range(niter):
        src = src + np.float32(1.0 + it % 3)
        acc = np.zeros_like(src)
        for d in halo.DIRECTIONS:
            for x in range(px):
                for y in range(py):
                    for z in range(pz):
                        srank = (x * py + y) * pz + z
                        tx, ty, tz = ((x + d[0]) % px, (y + d[1]) % py,
                                      (z + d[2]) % pz)
                        trank = (tx * py + ty) * pz + tz
                        sl = halo.surface_slices(n, d)
                        acc[(trank,) + sl] += src[(srank,) + sl]
    return src, acc


def numpy_exchange(halo, src, grid, n):
    """One periodic halo exchange of blocks ``src`` (R, *n): every rank's
    accumulator gets its 26 neighbours' surfaces, added in DIRECTIONS
    order (the order the unpack kernel adds in, so equality is exact)."""
    g = src.reshape(tuple(grid) + tuple(n))
    acc = np.zeros_like(g)
    for d in halo.DIRECTIONS:
        sl = (slice(None),) * 3 + halo.surface_slices(n, d)
        acc[sl] += np.roll(g[sl], shift=d, axis=(0, 1, 2))
    return acc.reshape(src.shape)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def event_ms(fn, reps=7, inner=1, warm=True):
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls,
    per call, after one warm-up call (unless ``warm`` is False)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, inner=20, reps=7):
    """Device time per call: ``inner`` calls captured in one CUDA graph,
    replayed ``reps`` times (median), so host overhead between launches
    is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return event_ms(graph.replay, reps=reps) / inner


def device_profile(run, out_path):
    """One ``run()`` under torch.profiler: {"busy_ms": device time,
    "top": its largest entries, "device_ops": kernels, memsets and copies
    the device ran, "host_calls": the CUDA launch/memset/copy API calls
    the host made, by name}; the full table goes to ``out_path``.
    ``busy_ms`` is None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    rows, device_ops, host_calls = [], 0, {}
    for e in avgs:
        if e.device_type != DeviceType.CUDA:
            if e.key.startswith("cu") and any(
                    w in e.key for w in ("Launch", "Memset", "Memcpy")):
                host_calls[e.key] = e.count
            continue            # host ops; their kernels are rows of their own
        device_ops += e.count
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    with open(out_path, "w") as f:
        f.write(avgs.table(sort_by="self_cpu_time_total", row_limit=40))
    return {"busy_ms": sum(r[0] for r in rows) if rows else None,
            "top": rows[:6], "device_ops": device_ops,
            "host_calls": host_calls}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(_build):
    t0 = time.perf_counter()
    built = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {}
    for name in _build.LIBRARIES:
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": secs, "built": sorted(built),
          "ptxas": ptxas})


def phase_kernels(dev, hp, hp_ref, bump, R=64):
    """Each kernel against its plain version on the same inputs (these
    launches are comparisons, made before the counted main-path runs)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    errs = {"halo_pack": 0.0, "halo_unpack": 0.0, "counter_bump": 0.0}
    for n in (N_FULL, (6, 5, 4)):
        field = torch.rand((R,) + n, generator=gen, device=dev)
        split, split_ref = hp.halo_pack_split(field), \
            hp_ref.halo_pack_split_ref(field)
        flat, flat_ref = hp.halo_pack(field), hp_ref.halo_pack_ref(field)
        ok = all(torch.equal(a, b) for a, b in zip(split, split_ref)) \
            and torch.equal(flat, flat_ref)
        errs["halo_pack"] = max(errs["halo_pack"], max(
            (a - b).abs().max().item() for a, b in
            zip(split + (flat,), split_ref + (flat_ref,))))
        check(ok, f"halo pack != plain pack at n={n}")
        recv = torch.randn(flat.shape, generator=gen, device=dev)
        parts = torch.split(recv, [p.shape[1] for p in split], dim=1)
        parts = [p.contiguous() for p in parts]
        acc, acc_ref = hp.halo_unpack(recv, n), hp_ref.halo_unpack_ref(recv, n)
        acc2 = hp.halo_unpack_split(parts, n)
        acc2_ref = hp_ref.halo_unpack_split_ref(parts, n)
        errs["halo_unpack"] = max(errs["halo_unpack"],
                                  (acc - acc_ref).abs().max().item(),
                                  (acc2 - acc2_ref).abs().max().item())
        check(torch.equal(acc, acc_ref) and torch.equal(acc2, acc2_ref),
              f"halo unpack != plain unpack at n={n}")
        emit({"phase": "kernels", "n": list(n), "R": R, "pack": "equal",
              "unpack": "equal"})
    sig = torch.randint(0, 1 << 20, (R, 26), generator=gen, device=dev,
                        dtype=torch.int32)
    upd = torch.randint(0, 3, (R, 26), generator=gen, device=dev,
                        dtype=torch.int32)
    out = bump(sig, upd)
    errs["counter_bump"] = float((out - (sig + upd)).abs().max().item())
    check(torch.equal(out, sig + upd), "counter bump != sig + upd")
    emit({"phase": "kernels", "bump": "equal", "max_abs_err": errs})
    return errs


def run_faces(core, dev, grid, n, niter, mode, src0, *, merged=True,
              throttle="adaptive", guard=False, ranks_per_node=None,
              **sched):
    """Build, allocate and run one Faces program through the port's entry
    points; returns (state, stream)."""
    stream = core.STStream(dev, AXES, grid_shape=grid)
    core.halo.build_faces_program(stream, n, niter, merged=merged,
                                  ranks_per_node=ranks_per_node)
    state = stream.allocate()
    state["faces.src"] = src0
    torch.cuda.synchronize()
    if guard:
        torch.cuda.set_sync_debug_mode("error")
    try:
        out = stream.synchronize(state, mode=mode, throttle=throttle,
                                 resources=16, merged=merged, **sched)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, stream


def phase_parity(core, dev):
    halo = core.halo
    R = int(np.prod(GRID_SMALL))
    src0 = np.random.RandomState(0).rand(R, *N_SMALL).astype(np.float32)
    src_exp, acc_exp = numpy_oracle(halo, src0)
    cases = [("st", thr, merged, {}) for merged in (True, False)
             for thr in ("adaptive", "static", "none")]
    cases += [("host", "adaptive", True, {}), ("host", "adaptive", False, {}),
              ("fused", "adaptive", True, {})]
    # two nodes of four ranks: the off-node puts pack into multi-buffer
    # descriptors (their recv buffers arrive as views of one staging
    # buffer) and chunk; a packed descriptor lands ONE completion for its
    # group, so only the post counters must equal niter there
    node = dict(ranks_per_node=4, node_aware=True, pack=True)
    cases += [("st", "adaptive", True, node),
              ("fused", "adaptive", True, dict(node, chunk_bytes=32))]
    for mode, thr, merged, sched in cases:
        out, _ = run_faces(core, dev, GRID_SMALL, N_SMALL, NITER_SMALL, mode,
                           torch.from_numpy(src0).to(dev), merged=merged,
                           throttle=thr, guard=mode != "host", **sched)
        np.testing.assert_allclose(out["faces.src"].cpu().numpy(), src_exp,
                                   rtol=1e-6)
        np.testing.assert_allclose(out["faces.acc"].cpu().numpy(), acc_exp,
                                   rtol=1e-5)
        counters = ("faces.post_sig",) if sched else ("faces.post_sig",
                                                      "faces.comp_sig")
        for c in counters:
            check((out[c].cpu().numpy() == NITER_SMALL).all(),
                  f"{mode}/{thr}/merged={merged}/{sched}: {c} != niter")
        emit({"phase": "parity", "mode": mode, "throttle": thr,
              "merged": merged, "sched": {k: v for k, v in sched.items()},
              "ok": True})


def phase_full(core, _build, dev):
    halo = core.halo
    R = int(np.prod(GRID_FULL))
    gen = torch.Generator(device=dev).manual_seed(0)
    src0 = torch.rand((R,) + N_FULL, generator=gen, device=dev)
    outs, launches, dispatches = {}, {}, {}
    for mode in MODES:
        _build.reset_launches()
        out, stream = run_faces(core, dev, GRID_FULL, N_FULL, NITER_FULL,
                                mode, src0, guard=mode != "host")
        launches[mode] = dict(_build.LAUNCHES)
        dispatches[mode] = stream.dispatches
        progs = stream.scheduled_programs(resources=16,
                                          fused=mode == "fused")
        if mode == "fused":
            want = sum(core.host_dispatch_count(p) for p in progs)
            check(stream.dispatches == want,
                  f"fused dispatches {stream.dispatches} != {want}")
        if mode == "st":
            check(stream.dispatches == sum(len(p.nodes) for p in progs),
                  "st dispatches != descriptor count")
        for k, v in _build.LAUNCHES.items():
            check(v > 0, f"{mode}: kernel {k} was not launched")
        for c in ("faces.post_sig", "faces.comp_sig"):
            check(bool((out[c] == NITER_FULL).all()), f"{mode}: {c} != niter")
        outs[mode] = out
        emit({"phase": "full", "mode": mode, "grid": list(GRID_FULL),
              "n": list(N_FULL), "niter": NITER_FULL,
              "launches": launches[mode],
              "sim_dispatch_units": stream.dispatches})
    for mode in ("host", "fused"):
        for k in outs["st"]:
            check(torch.equal(outs[mode][k], outs["st"][k]),
                  f"{mode} differs from st on {k}")
    st = outs["st"]
    src = st["faces.src"].cpu().numpy()
    check(np.isfinite(src).all() and src.shape == (R,) + N_FULL,
          "src not finite / wrong shape")
    total = sum(1.0 + it % 3 for it in range(NITER_FULL))
    np.testing.assert_allclose(src, src0.cpu().numpy() + total, rtol=1e-6)
    acc = st["faces.acc"].cpu().numpy()
    check(np.array_equal(acc, numpy_exchange(halo, src, GRID_FULL, N_FULL)),
          "acc != numpy exchange of the final blocks")
    res = st["faces.res"].cpu().numpy()
    check(np.array_equal(res[:, 0], np.abs(acc).reshape(R, -1).max(1)),
          "res != per-rank max|acc|")
    emit({"phase": "full", "bit_identical_modes": ["st", "host", "fused"],
          "exchange_exact": True})
    return launches, dispatches


def phase_timing(core, hp, hp_ref, bump, bump_ref, dev, launches,
                 dispatches, errs):
    R = int(np.prod(GRID_FULL))
    gen = torch.Generator(device=dev).manual_seed(2)
    src0 = torch.rand((R,) + N_FULL, generator=gen, device=dev)
    runs = {}
    for mode in MODES:
        stream = core.STStream(dev, AXES, grid_shape=GRID_FULL)
        core.halo.build_faces_program(stream, N_FULL, NITER_FULL)
        state = stream.allocate()
        state["faces.src"] = src0
        runs[mode] = (lambda stream=stream, state=state, mode=mode:
                      stream.synchronize(state, mode=mode, resources=16))
        runs[mode]()                                    # warm-up
    # the modes take turns (order reversed every round), so a slow
    # stretch of the shared host does not land on one mode only
    times = {m: [] for m in MODES}
    for rnd in range(7):
        for mode in (MODES if rnd % 2 == 0 else MODES[::-1]):
            times[mode].append(event_ms(runs[mode], reps=1, warm=False))
    for mode in MODES:
        ts = sorted(times[mode])
        ms = statistics.median(ts)
        prof = device_profile(
            runs[mode], os.path.join(OUT_DIR, f"profile_faces_{mode}.txt"))
        busy = prof["busy_ms"]
        emit({"phase": "timing", "mode": mode, "iter_ms": ms / NITER_FULL,
              "program_ms": ms, "program_ms_runs": ts, "niter": NITER_FULL,
              # the cost simulator's accounting unit (one per descriptor,
              # one per segment in fused mode), not a launch count
              "sim_dispatch_units_per_iter": dispatches[mode] / NITER_FULL,
              # what the host really issued: every device op was launched
              # by one host call
              "device_ops_per_iter": prof["device_ops"] / NITER_FULL,
              "host_calls_per_iter": {k: v / NITER_FULL for k, v in
                                      sorted(prof["host_calls"].items())},
              "device_busy_ms": busy,
              "device_idle_share": None if busy is None else 1 - busy / ms,
              "top_device_ms": [[round(t, 4), k, c]
                                for t, k, c in prof["top"]]})

    field = torch.rand((R,) + N_FULL, generator=gen, device=dev)
    _, total = core.halo.offsets_of(N_FULL)
    cells = field[0].numel()
    # the boundary shell: the distinct cells the 26 surfaces cover (an
    # edge cell is in 3 surfaces, a corner cell in 7), read once each
    shell = cells - int(np.prod([max(x - 2, 0) for x in N_FULL]))
    # the library yardsticks' index: flat cell of every surface element,
    # in offsets_of order (built once, like the kernels' geometry)
    grid = np.arange(cells).reshape(N_FULL)
    idx = torch.as_tensor(np.concatenate(
        [grid[core.halo.surface_slices(N_FULL, d)].ravel()
         for d in core.halo.DIRECTIONS]), device=dev)
    zero_acc = torch.zeros((R, cells), device=dev)
    recv = hp.halo_pack(torch.randn(field.shape, generator=gen, device=dev))
    sig = torch.zeros((R, 26), dtype=torch.int32, device=dev)
    upd = torch.ones((R, 26), dtype=torch.int32, device=dev)

    def lib_pack():
        return field.view(R, cells).index_select(1, idx)

    def lib_unpack():
        return zero_acc.index_add(1, idx, recv)

    # each yardstick against the kernel on the same inputs: index_select
    # and add are exact; index_add adds with atomics in an unspecified
    # order, so it is held to float32 rounding of <= 7 adds
    # (rtol 1.3e-6, atol 1e-5)
    pairs = {"halo_pack": (lib_pack(), hp.halo_pack(field)),
             "halo_unpack": (lib_unpack().view(field.shape),
                             hp.halo_unpack(recv, N_FULL)),
             "counter_bump": (torch.add(sig, upd), bump(sig, upd))}
    check(torch.equal(*pairs["halo_pack"]), "index_select != halo_pack")
    check(torch.equal(*pairs["counter_bump"]), "torch.add != counter_bump")
    torch.testing.assert_close(*pairs["halo_unpack"], rtol=1.3e-6,
                               atol=1e-5)
    lib_err = {k: float((a - b).abs().max().item())
               for k, (a, b) in pairs.items()}
    rows = [
        ("halo_pack", "src/repro_torch/csrc/halo_pack.cu",
         "src/repro/kernels/halo_pack/kernel.py:39",
         lambda: hp.halo_pack(field), lambda: hp_ref.halo_pack_ref(field),
         lib_pack, "torch.index_select", R * (shell + total) * 4),
        ("halo_unpack", "src/repro_torch/csrc/halo_pack.cu",
         "src/repro/kernels/halo_pack/kernel.py:53",
         lambda: hp.halo_unpack(recv, N_FULL),
         lambda: hp_ref.halo_unpack_ref(recv, N_FULL),
         lib_unpack, "torch.index_add (zero base)",
         R * (total + cells) * 4),
        ("counter_bump", "src/repro_torch/csrc/counter_bump.cu",
         "src/repro/core/engine.py:67",
         lambda: bump(sig, upd), lambda: bump_ref(sig, upd),
         lambda: torch.add(sig, upd), "torch.add", 3 * sig.numel() * 4),
    ]
    kernels = []
    for name, source, replaces, kern, plain, lib, lib_name, nbytes in rows:
        # ms/plain_ms/library_ms: device time per call (CUDA graph);
        # *call_ms: eager calls back to back, host overhead included.
        # Pack/unpack are timed in their flat forms, where the plain
        # version materializes the same bytes (its split pack returns
        # views); the main path's split forms run the same kernels.
        # bound: each input read once, each output written once.
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(launches[m][name] for m in launches),
            "launches_by_mode": {m: launches[m][name] for m in launches},
            "max_abs_err": errs[name], "ms": graph_ms(kern),
            "plain_ms": graph_ms(plain),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes,
            "library_ms": graph_ms(lib), "library": lib_name,
            "library_max_abs_err": lib_err[name],
            "call_ms": event_ms(kern, inner=20),
            "plain_call_ms": event_ms(plain, inner=20),
            "library_call_ms": event_ms(lib, inner=20)})
    return kernels


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch.core as core
    from repro_torch.kernels import _build
    from repro_torch.kernels.counter_bump import (counter_bump,
                                                  counter_bump_ref)
    from repro_torch.kernels.halo_pack import ops as hp
    from repro_torch.kernels.halo_pack import ref as hp_ref

    dev = torch.device("cuda", 0)
    os.makedirs(OUT_DIR, exist_ok=True)
    emit({"phase": "start", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    phase_build(_build)
    errs = phase_kernels(dev, hp, hp_ref, counter_bump)
    phase_parity(core, dev)
    launches, dispatches = phase_full(core, _build, dev)
    kernels = phase_timing(core, hp, hp_ref, counter_bump, counter_bump_ref,
                           dev, launches, dispatches, errs)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(json.dumps({"kernels": kernels}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
