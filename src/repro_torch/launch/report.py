"""Tables from the port's JSON records, as the JAX package's
``launch/report.py``.

  python -m repro_torch.launch.report --dir results/dryrun_torch
  python -m repro_torch.launch.report --what st --dir results/st
  python -m repro_torch.launch.report --what serve --dir results/serve

The ``st`` table reads the records ``benchmarks/faces_worker.py
--json-dir`` writes: per-program triggered-op descriptor stats
(puts/epoch, resource high-water mark, critical-path depth) next to the
measured and derived times. The ``serve`` table reads the traffic-driver
summaries ``python -m repro_torch.launch.traffic --out`` writes: p50/p99
end-to-end latency, p50/p99 TTFT, and tokens/sec per run, with the
st_mode and replica count that produced them.

The dry-run tables read ``launch/dryrun.py``'s records: the fit column
is one H100's 80 GB (the reference's a v5e's 16 GB), and a record
without collective counts (the port reads no HLO) shows an em-dash.
"""
from __future__ import annotations

import argparse
import json
import os


def load_records(d):
    recs = []
    for name in sorted(os.listdir(d)):
        if name.endswith(".json"):
            recs.append(json.load(open(os.path.join(d, name))))
    return recs


def fmt_bytes(b):
    return f"{b/2**30:.1f}G" if b >= 2**30 else f"{b/2**20:.0f}M"


def dryrun_table(recs, mesh=None):
    rows = ["| arch | shape | mesh | status | peak/dev | fits 80G | "
            "coll bytes/dev | coll ops |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if mesh and r.get("mesh") != mesh:
            continue
        if r.get("status") == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"skipped (sub-quadratic only) | — | — | — | — |")
            continue
        if r.get("status") != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"ERROR | — | — | — | — |")
            continue
        m = r["memory"]
        c = r.get("collectives")
        coll = r.get("collective_bytes_per_device")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{fmt_bytes(m.get('peak_bytes_est', 0))} | "
            f"{'yes' if m.get('fits_80gb') else 'NO'} | "
            f"{'—' if coll is None else fmt_bytes(coll)} | "
            f"{'—' if c is None else c.get('total_count', 0)} |")
    return "\n".join(rows)


def roofline_table(recs, mesh="16x16"):
    rows = ["| arch | shape | compute s | memory s | collective s | "
            "dominant | bound step s | roofline frac | useful flops |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("status") != "ok" or r.get("mesh") != mesh:
            continue
        rf = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.3f} | "
            f"{rf['memory_s']:.3f} | {rf['collective_s']:.3f} | "
            f"{rf['dominant']} | {rf['step_s']:.3f} | "
            f"{rf['roofline_fraction']:.3f} | "
            f"{r['useful_flops_ratio']:.2f} |")
    return "\n".join(rows)


def _num(val, fmt):
    """Render a possibly-missing numeric field; None (e.g. no real R for
    an unbounded throttle policy, or a record predating the column) is
    an em-dash, never a KeyError."""
    return "—" if val is None else format(val, fmt)


def st_stats_table(recs):
    """Descriptor-DAG stats per ST benchmark run (faces_worker
    --json-dir records, any pattern). Records written before a column
    existed (pre-overlap nstreams/double_buffer, pre-topology R/link
    fields) render with defaults instead of raising."""
    rows = ["| name | pattern | exec | throttle | R | streams | dbuf | "
            "node-aware | packed | chunks | mcast | segs | us/iter | "
            "derived | puts/epoch | inter | hwm | crit depth | "
            "dep edges |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"
            "---|---|---|---|---|"]
    for r in recs:
        if "stats" not in r:
            continue
        s = r["stats"]
        pattern = r.get("pattern") or s.get("pattern") or "faces"
        nstreams = r.get("nstreams") or s.get("nstreams", 1)
        dbuf = r.get("double_buffer", s.get("double_buffer", False))
        node_aware = r.get("node_aware", s.get("node_aware", False))
        # packed / chunked / multicast descriptor counts per program
        # (0 for records predating each feature)
        packed = s.get("packed_puts", 0)
        chunks = s.get("chunked_puts", 0)
        mcast = s.get("multicast_puts", 0)
        # an unbounded policy (none/application) holds no slots: its
        # record carries resources=None and renders as "—"
        res = r.get("resources", s.get("resources"))
        # exec = which stage-3 consumer ran (st/host/fused); segs = the
        # planner's segment count (0 for unfused records and records
        # predating the progress engine)
        segs = s.get("segments", 0) if s.get("fused") else 0
        rows.append(
            f"| {r.get('name', '?')} | {pattern} | {r.get('mode', '-')} | "
            f"{r.get('throttle', '-')} | {_num(res, 'd')} | {nstreams} | "
            f"{'y' if dbuf else 'n'} | {'y' if node_aware else 'n'} | "
            f"{packed} | {chunks} | {mcast} | {segs} | "
            f"{_num(r.get('us_per_iter'), '.1f')} | "
            f"{_num(r.get('derived_us_per_iter'), '.2f')} | "
            f"{_num(s.get('puts_per_epoch'), '.0f')} | "
            f"{s.get('inter_puts', 0)} | "
            f"{s.get('resource_high_water', 0)} | "
            f"{_num(s.get('critical_path_depth'), 'd')} | "
            f"{s.get('dep_edges', 0)} |")
    return "\n".join(rows)


def serve_table(recs):
    """Serving-traffic summaries (repro_torch.launch.traffic --out records):
    one row per run — arrival rate, replica fleet, decode routing mode,
    latency/TTFT percentiles, and aggregate token rate. Records missing
    a field (older drivers) render with em-dashes instead of raising."""
    rows = ["| requests | rate/s | replicas | st_mode | drained | "
            "lat p50 ms | lat p99 ms | ttft p50 ms | ttft p99 ms | "
            "tok/s |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if "latency_p50_ms" not in r:
            continue
        st = r.get("st_mode") or "baseline"
        rows.append(
            f"| {r.get('requests', '—')} | "
            f"{_num(r.get('rate'), '.0f')} | "
            f"{r.get('replicas', '—')} | {st} | "
            f"{'y' if r.get('queue_drained') else 'n'} | "
            f"{_num(r.get('latency_p50_ms'), '.0f')} | "
            f"{_num(r.get('latency_p99_ms'), '.0f')} | "
            f"{_num(r.get('ttft_p50_ms'), '.0f')} | "
            f"{_num(r.get('ttft_p99_ms'), '.0f')} | "
            f"{_num(r.get('tokens_per_s'), '.1f')} |")
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--what", default="both",
                    choices=["both", "dryrun", "roofline", "st", "serve"])
    args = ap.parse_args()
    recs = load_records(args.dir)
    if args.what == "st":
        print("### ST descriptor-DAG stats\n")
        print(st_stats_table(recs))
        return
    if args.what == "serve":
        print("### Serving traffic (Poisson driver)\n")
        print(serve_table(recs))
        return
    if args.what in ("both", "dryrun"):
        print("### Dry-run records\n")
        print(dryrun_table(recs, args.mesh))
        print()
    if args.what in ("both", "roofline"):
        print("### Roofline (single pod, 16x16)\n")
        print(roofline_table(recs, "16x16"))
        print("\n### Roofline (one card)\n")
        print(roofline_table(recs, "none"))


if __name__ == "__main__":
    main()
