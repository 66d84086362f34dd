"""The control of a served DeepSeek-V2 cell, run by hand on the card (the
benchmark's own runs never run it): the plain reference
(``stbench/reference/deepseek_v2.py``) computed with float8 e4m3
products, one precision below the configuration's bf16, in the
program's place.

    python3 stbench/control_deepseek.py --workload deepseek-v2-lite-decode \\
        --seeds 1,2,3 --seconds 51 [--control 1]

For each seed, in one process, it runs the cell as a benchmark run does
(set-up, a window of ``--seconds``, the program's own checks) and prints
one JSON line: the program's reading of each compared number, the cell's
end-to-end metrics, and with ``--control 1`` the control's reading on
the same checked requests: at each position of their prompts and served
tokens, the float32 gap of the token that the float8 reference puts
first, averaged (its widest and the program's beside it). Its readings
and the program's set the cell's limit (PERF.md).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]


def control(extra) -> dict:
    """The control's mean gap, and beside it both sides' gaps over the
    same tokens."""
    from stbench.control import gap_stats
    from stbench.reference import deepseek_v2 as ref
    w, m = extra["weights"], extra["model"]
    low = [ref.control_gaps(w, m, p, s) for p, s in extra["checked"]]
    prog = [ref.served_gaps(w, m, p, s) for p, s in extra["checked"]]
    control, program = gap_stats(low), gap_stats(prog)
    return {"mean_logit_gap": control["mean"], "control": control,
            "program": program}


def main(argv):
    ap = argparse.ArgumentParser(prog="stbench/control_deepseek.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch
    from stbench import harness
    if not torch.cuda.is_available():
        print("stbench control: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    _, config, mix, limits = harness.cell_files(bench, args.workload)
    driver = importlib.import_module(f"stbench.drivers.{config['driver']}")
    t_start = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(workload=args.workload, config=config,
                              mix=mix, seed=seed, seconds=args.seconds,
                              trace=False, device=torch.device("cuda", 0),
                              t_start=t_start)
        out = driver.run(ctx)
        line = {"workload": args.workload, "seed": seed,
                "program": out.checks, "limits": limits,
                "metrics": {m["name"]: harness.read_metric(m["name"],
                                                           out.rec)
                            for m in harness.cell_metrics(
                                bench, args.workload, False)},
                "memory_peak_bytes": out.memory_peak_bytes}
        if args.control:
            line["control"] = control(out.extra)
        line["seconds"] = time.perf_counter() - t_start
        print(json.dumps(line), flush=True)
        del out
        gc.collect()                # the router's dispatch stand-in cycle
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
