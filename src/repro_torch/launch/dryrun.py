"""Dry-run driver of the port: the accounting of every (architecture x
input shape) cell, per mesh, without a device (``dryrun_lib.py``).

The JAX package's driver lowers and compiles each cell with XLA on the
production meshes (16x16 single pod, 2x16x16 multi-pod) and prints
memory_analysis() and cost_analysis(). The port lowers nothing: it
counts each cell from its own step on fake tensors and writes one JSON
record per (arch, shape, mesh), whose ``not_counted`` names what XLA
would have given and the port does not have. ``--mesh none`` accounts
one card. The reference's ``--light`` (one compile, no probe) has no
meaning without a compile and is not kept; ``--all`` runs every cell in
this process (no compile state to isolate).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k \
      --multi-pod
  python -m repro_torch.launch.dryrun --arch granite-3-2b \
      --shape decode_32k --mesh none
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh (same as --mesh 2x16x16)")
    ap.add_argument("--mesh", default=None,
                    choices=("none", "16x16", "2x16x16"),
                    help="none: one card; default 16x16")
    ap.add_argument("--moe-impl", default="gshard")
    ap.add_argument("--overrides", default=None,
                    help="JSON dict of sharding-rule overrides (hillclimb)")
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape x mesh (none, 16x16, "
                         "2x16x16)")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun_lib import MESHES, run_cell, save_record
    overrides = json.loads(args.overrides) if args.overrides else None
    if args.all:
        from repro_torch.configs import ARCH_IDS, SHAPES
        bad = 0
        for arch in ARCH_IDS:
            for shape in SHAPES:
                for mesh in MESHES:
                    path = os.path.join(args.out,
                                        f"{arch}__{shape}__{mesh}.json")
                    if args.skip_existing and os.path.exists(path):
                        print(f"skip {arch} {shape} {mesh}")
                        continue
                    rec = run_cell(arch, shape, mesh=mesh,
                                   overrides=overrides,
                                   moe_impl=args.moe_impl)
                    save_record(rec, args.out)
                    bad += rec["status"] == "error"
                    print(f"== {arch} {shape} {mesh}: {rec['status']} "
                          f"{rec.get('count_s', '')}", flush=True)
        return 1 if bad else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    mesh = args.mesh or ("2x16x16" if args.multi_pod else "16x16")
    rec = run_cell(args.arch, args.shape, mesh=mesh, overrides=overrides,
                   moe_impl=args.moe_impl)
    path = save_record(rec, args.out)
    brief = {k: rec.get(k) for k in
             ("arch", "shape", "mesh", "status", "count_s", "roofline",
              "memory", "useful_flops_ratio", "error")}
    print(json.dumps(brief, indent=1))
    print(f"-> {path}")
    if rec.get("status") == "error":
        print(rec.get("traceback", ""), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
