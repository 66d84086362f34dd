"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file found by its name:

  * ``BENCHMARK.json``'s configuration entry names its ``file``, which
    names the ``driver`` (``stbench/drivers/<driver>.py``) that runs it;
  * ``stbench/traffic/<traffic>.json``: the mix (``traffic.py``);
  * ``stbench/limits/<workload>.json``: each compared number's limit;
  * ``stbench/metrics/<metric>.py``: ``read(rec)`` takes the metric from
    the record the driver returns, or returns None where it finds
    nothing to read (the metric is then left out of the line).

A driver's ``run(ctx)`` sets up, measures for ``ctx.seconds``, checks
the outputs against the plain reference and returns a :class:`Record`.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

from stbench.traffic import load_mix

STBENCH = Path(__file__).resolve().parent
ROOT = STBENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    workload: str
    config: dict            # the configuration's file
    mix: dict               # the traffic mix's file
    seed: int
    seconds: float
    trace: bool
    device: object          # torch.device
    t_start: float          # perf_counter at process start


@dataclasses.dataclass
class Record:
    """What a driver hands back. ``rec`` holds every quantity a metric
    reader takes (its keys are the driver's, named in its module doc);
    ``checks``: {compared number: its value}."""
    rec: dict
    checks: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: dict = None      # devtrace.Trace.reduce() of a traced run
    extra: dict = None      # what the control script reads (control.py)


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_files(bench: dict, workload: str):
    """(cell entry, configuration file, mix, limits) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"stbench: no workload {workload!r} in "
                         f"BENCHMARK.json ({sorted(cells)})")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    mix = load_mix(cell["traffic"])
    limits = json.loads((STBENCH / "limits" / f"{workload}.json")
                        .read_text())
    return cell, config, mix, limits


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` prints: its end-to-end ones, or
    with ``trace`` its per-layer ones."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]


def read_metric(name: str, rec: dict):
    spec = importlib.util.spec_from_file_location(
        f"stbench_metric_{name}", STBENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def run_cell(bench: dict, workload: str, *, seed: int, seconds: float,
             trace: bool, device, t_start: float, overrides: dict = None):
    """Run ``workload`` once on ``device``: (result dict, checks as
    {name: [value, limit]}). ``overrides`` replaces the files' config,
    mix or limits (tests run tiny cells through here)."""
    cell, config, mix, limits = cell_files(bench, workload)
    over = overrides or {}
    config = over.get("config", config)
    mix = over.get("mix", mix)
    limits = over.get("limits", limits)
    driver = importlib.import_module(f"stbench.drivers.{config['driver']}")
    ctx = Context(workload=workload, config=config, mix=mix, seed=int(seed),
                  seconds=float(seconds), trace=bool(trace), device=device,
                  t_start=t_start)
    out = driver.run(ctx)
    checks = {k: [v, limits[k]] for k, v in out.checks.items()}
    correct = all(v is not None and v <= lim for v, lim in checks.values())
    metrics = {}
    if trace:
        out.rec["trace"] = out.trace
        print("stbench trace: " + json.dumps(
            {k: out.trace[k] for k in ("window_s", "busy_s", "events",
                                       "reduce_s", "diag")}),
              file=sys.stderr)
    for m in cell_metrics(bench, workload, trace):
        value = read_metric(m["name"], out.rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (_device_name(device)), "count": cell["chips"],
           "memory_peak_bytes": out.memory_peak_bytes}
    if trace:
        dev["busy_s"] = out.trace["busy_s"]
        dev["window_s"] = out.trace["window_s"]
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if trace:
        from stbench.devtrace import breakdown
        result["breakdown"] = breakdown(out.trace)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks


def _device_name(device) -> str:
    if device.type == "cuda":
        import torch
        return torch.cuda.get_device_name(device)
    return device.type


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="stbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_benchmark()
    cell, *_ = cell_files(bench, args.workload)
    src = ROOT / "src"
    spec = importlib.util.find_spec("repro_torch")
    if spec is None or Path(spec.origin).resolve().parent.parent != src:
        print(f"stbench: the program (repro_torch) is not in {src}",
              file=sys.stderr)
        return 2
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"stbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees {cards}", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    print(f"stbench: {power_limit()}; peaks 989 TFLOP/s bf16, 67 float32, "
          "3.35 TB/s (H100 SXM data sheet)", file=sys.stderr, flush=True)
    result, checks = run_cell(bench, args.workload, seed=args.seed,
                              seconds=args.seconds, trace=bool(args.trace),
                              device=torch.device("cuda", 0),
                              t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"stbench: the run loaded {bad}; the benchmark may load "
              "neither JAX nor the JAX package", file=sys.stderr)
        return 3
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
