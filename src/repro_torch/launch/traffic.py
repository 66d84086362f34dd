"""Multi-replica Poisson traffic driver for the port's serving engine.

Stands in for production traffic: requests arrive as a Poisson process
(exponential inter-arrival gaps, fixed seed) with configurable prompt-
length and max-token distributions, are routed to the least-loaded of N
engine replicas, and carry per-request queue/prefill/decode timestamps
(``submitted_at`` / ``admitted_at`` / ``first_token_at`` / ``done_at``)
so the summary reports p50/p99 end-to-end latency, p50/p99 TTFT, and
aggregate tokens/sec. Thousands of in-flight requests are just a
``requests=``/``rate=`` choice — the driver loop is O(1) per arrival
(deque admission) and each replica steps only while it has work.

``st_mode`` routes every replica's decode-step collectives through
scheduled triggered-op programs (repro_torch.serving.st_decode) on
``st_ranks`` virtual ranks; the summary then carries each replica's
serve-program meta so SLO gating can assert the collectives really ran
on the ST path. Engines run on ``device`` (the card by default, "cpu"
for the plain path); ``run_traffic(tcfg, engines=...)`` takes engines
built elsewhere (a full-width model on the card, say).

  python -m repro_torch.launch.traffic --requests 64 --rate 200 \\
      --replicas 2 --st-mode st --out results/serve/traffic_torch.json
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import asdict, dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class TrafficConfig:
    requests: int = 64
    rate: float = 200.0                  # mean arrivals per second
    replicas: int = 1
    batch_slots: int = 4
    max_len: int = 64
    prompt_len: Tuple[int, int] = (2, 12)   # uniform [lo, hi]
    max_new: Tuple[int, int] = (2, 12)      # uniform [lo, hi]
    eos_id: int = -1
    seed: int = 0
    arch: str = "granite-3-2b"           # always .reduced() by the driver
    moe_impl: str = "dense"
    st_mode: Optional[str] = None        # None | "st" | "host" | "fused"
    st_config: object = "auto"
    tuned_path: Optional[str] = None
    st_ranks: int = 1                    # virtual ranks of the collective
    device: str = "cuda"


def make_engines(tcfg: TrafficConfig) -> list:
    """N identical serving replicas of the (reduced) arch, random params
    from ``tcfg.seed`` in the config's compute dtype."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.compat import resolve_device
    from repro_torch.models import init_params, model_specs
    from repro_torch.serving import ServingEngine

    cfg = get_config(tcfg.arch).reduced()
    device = resolve_device(tcfg.device)
    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    params = init_params(model_specs(cfg), gen, device,
                         getattr(torch, cfg.compute_dtype))
    return [ServingEngine(cfg, params, batch_slots=tcfg.batch_slots,
                          max_len=tcfg.max_len, moe_impl=tcfg.moe_impl,
                          st_mode=tcfg.st_mode, st_config=tcfg.st_config,
                          tuned_path=tcfg.tuned_path,
                          st_ranks=tcfg.st_ranks, device=device)
            for _ in range(tcfg.replicas)]


def sample_arrivals(tcfg: TrafficConfig, vocab_size: int):
    """Pre-sampled request stream: Poisson arrival offsets (seconds from
    start), prompts, and per-request max-token budgets."""
    rng = np.random.RandomState(tcfg.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / max(tcfg.rate, 1e-9),
                                         size=tcfg.requests))
    plens = rng.randint(tcfg.prompt_len[0], tcfg.prompt_len[1] + 1,
                        size=tcfg.requests)
    max_new = rng.randint(tcfg.max_new[0], tcfg.max_new[1] + 1,
                          size=tcfg.requests)
    prompts = [rng.randint(1, vocab_size, size=int(p)).astype(np.int32)
               for p in plens]
    return arrivals, prompts, max_new


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def _busy(engine) -> bool:
    return bool(engine.queue) or bool(engine._active())


def run_traffic(tcfg: TrafficConfig, engines: Optional[list] = None) -> dict:
    """Drive the Poisson stream through the replicas until every request
    completes; returns the latency/TTFT/throughput summary (plus each
    replica's serving stats, including ST program meta)."""
    from repro_torch.serving import Request

    engines = engines if engines is not None else make_engines(tcfg)
    vocab = int(engines[0].cfg.vocab_size)
    arrivals, prompts, max_new = sample_arrivals(tcfg, vocab)
    reqs: List[Request] = []
    t0 = time.monotonic()
    nxt = 0
    while nxt < tcfg.requests or any(_busy(e) for e in engines):
        now = time.monotonic() - t0
        while nxt < tcfg.requests and arrivals[nxt] <= now:
            eng = min(engines,
                      key=lambda e: len(e.queue) + len(e._active()))
            req = Request(prompt=prompts[nxt],
                          max_new_tokens=int(max_new[nxt]),
                          eos_id=tcfg.eos_id)
            reqs.append(req)
            eng.submit(req)
            nxt += 1
        stepped = 0
        for eng in engines:
            if _busy(eng):
                stepped += eng.step()
        if not stepped and nxt < tcfg.requests:
            # idle until the next arrival is due
            time.sleep(min(1e-3, max(arrivals[nxt] - (time.monotonic()
                                                      - t0), 0.0)))
    wall = time.monotonic() - t0

    done = [r for r in reqs if r.done_at is not None]
    lat = [r.done_at - r.submitted_at for r in done]
    ttft = [r.first_token_at - r.submitted_at for r in done
            if r.first_token_at is not None]
    tokens = sum(len(r.out_tokens) for r in done)
    drained = (len(done) == tcfg.requests
               and not any(_busy(e) for e in engines))
    return {
        "requests": tcfg.requests, "completed": len(done),
        "replicas": tcfg.replicas, "st_mode": tcfg.st_mode,
        "rate": tcfg.rate, "seed": tcfg.seed,
        "queue_drained": drained, "wall_s": wall,
        "latency_p50_ms": _pct(lat, 50) * 1e3,
        "latency_p99_ms": _pct(lat, 99) * 1e3,
        "ttft_p50_ms": _pct(ttft, 50) * 1e3,
        "ttft_p99_ms": _pct(ttft, 99) * 1e3,
        "tokens": tokens,
        "tokens_per_s": tokens / max(wall, 1e-9),
        "per_replica": [e.stats() for e in engines],
        "config": {k: v for k, v in asdict(tcfg).items()
                   if k != "st_config"},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Poisson traffic driver over N serving replicas")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="mean arrivals per second")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(2, 12),
                    metavar=("LO", "HI"))
    ap.add_argument("--max-new", type=int, nargs=2, default=(2, 12),
                    metavar=("LO", "HI"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--st-mode", default=None,
                    choices=[None, "st", "host", "fused"])
    ap.add_argument("--st-ranks", type=int, default=1,
                    help="virtual ranks of the ST decode collective")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--out", default=None,
                    help="write the JSON summary here "
                         "(e.g. results/serve/traffic_torch.json)")
    args = ap.parse_args(argv)

    tcfg = TrafficConfig(requests=args.requests, rate=args.rate,
                         replicas=args.replicas, batch_slots=args.slots,
                         max_len=args.max_len,
                         prompt_len=tuple(args.prompt_len),
                         max_new=tuple(args.max_new), seed=args.seed,
                         arch=args.arch, st_mode=args.st_mode,
                         st_ranks=args.st_ranks, device=args.device)
    summary = run_traffic(tcfg)
    print(f"served {summary['completed']}/{summary['requests']} requests "
          f"on {summary['replicas']} replica(s) in {summary['wall_s']:.2f}s "
          f"({summary['tokens_per_s']:.1f} tok/s, st_mode="
          f"{summary['st_mode']})")
    print(f"latency p50={summary['latency_p50_ms']:.0f}ms "
          f"p99={summary['latency_p99_ms']:.0f}ms | "
          f"ttft p50={summary['ttft_p50_ms']:.0f}ms "
          f"p99={summary['ttft_p99_ms']:.0f}ms")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
        print(f"wrote {args.out}")
    return summary


if __name__ == "__main__":
    main()
