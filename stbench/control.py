"""The controls of the comparisons that decide ``correct``: the plain
reference put in the program's place and computed one precision below
the configuration's. A control has to come out not correct; its
readings and the program's set each limit (see PERF.md).

    python3 stbench/control.py --workload <name> --seeds 1,2,3 --seconds <s>

For each seed it runs the cell as a benchmark run does (set-up, a
window of ``--seconds``, the program's own check) and prints one JSON
line: the program's reading of each compared number and the control's
on the same inputs:

  * Faces: the replay in bfloat16 (every addition rounded to it) against
    the float32 replay, after as many iterations as the run made;
  * a served model: at each position of the checked requests' prompts
    and served tokens, the float32 gap of the token that the reference
    computed with float8 (e4m3) products puts first.

The benchmark's own runs never run a control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]


def bf16_rounding(x):
    import numpy as np
    import torch
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def faces_control(extra) -> int:
    import numpy as np
    from stbench.reference.faces import FacesReplay, mismatches
    args = (extra["index"], extra["values"].astype(np.float32),
            extra["grid"])
    exact = FacesReplay(*args, window=extra["window"])
    low = FacesReplay(*args, window=extra["window"], rounding=bf16_rounding)
    k = extra["iterations"]
    return mismatches(low.state(k), exact.state(k))


def gap_stats(gaps) -> dict:
    import numpy as np
    g = np.concatenate(gaps)
    return {"max": float(g.max()), "mean": float(g.mean()),
            "p99": float(np.percentile(g, 99)),
            "off_best": float((g > 0).mean()), "tokens": int(g.size)}


def serve_control(extra) -> dict:
    """The control's widest gap, and beside it the spread of both sides'
    gaps over the same tokens."""
    from stbench.reference import granite as ref
    w, m = extra["weights"], extra["model"]
    low = [ref.control_gaps(w, m, p, s) for p, s in extra["checked"]]
    prog = [ref.served_gaps(w, m, p, s) for p, s in extra["checked"]]
    return {"max_logit_gap": float(max(g.max() for g in low)),
            "control": gap_stats(low), "program": gap_stats(prog)}


CONTROLS = {"faces": faces_control, "serve": serve_control}


def readings(bench, workload, seed, seconds, device, overrides=None):
    """(the program's checks, the control's reading) of one seed."""
    import importlib
    from stbench import harness
    _, config, mix, _ = harness.cell_files(bench, workload)
    over = overrides or {}
    config = over.get("config", config)
    ctx = harness.Context(workload=workload, config=config,
                          mix=over.get("mix", mix), seed=seed,
                          seconds=seconds, trace=False, device=device,
                          t_start=time.perf_counter())
    driver = importlib.import_module(f"stbench.drivers.{config['driver']}")
    out = driver.run(ctx)
    return out.checks, CONTROLS[config["driver"]](out.extra)


def main(argv):
    ap = argparse.ArgumentParser(prog="stbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    from stbench import harness
    if not torch.cuda.is_available():
        print("stbench control: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        program, control = readings(bench, args.workload, seed,
                                    args.seconds, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": program, "control": control,
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
