"""Serving launcher: batched prefill/decode with slot recycling, on the
card by default.

  python -m repro_torch.launch.serve --arch granite-3-2b
  python -m repro_torch.launch.serve --arch rwkv6-1.6b
  python -m repro_torch.launch.serve --arch rwkv6-1.6b --reduced \\
      --device cpu --requests 8 --slots 4 --max-new 16
  python -m repro_torch.launch.serve --arch jamba-1.5-large-398b \\
      --reduced --device cpu --moe-impl gshard
  python -m repro_torch.launch.serve --arch deepseek-v2-236b \\
      --reduced --device cpu
  python -m repro_torch.launch.serve --arch musicgen-large
  python -m repro_torch.launch.serve --arch llama-3.2-vision-90b \\
      --reduced --device cpu

``--arch`` takes every architecture of the registry (granite-3-2b,
qwen3-32b, minitron-4b, granite-34b, rwkv6-1.6b, jamba-1.5-large-398b,
deepseek-v2-236b, deepseek-moe-16b, llama-3.2-vision-90b,
musicgen-large); ``--moe-impl`` the MoE layers'
implementation (the reference's choices; "dense" is its default, "a2a"
the gather-based expert-parallel MoE on one shard). A vlm's prefill
gets zero vision inputs and musicgen-large is fed token ids, as the
reference's engine does. Models larger than one card in bf16 (the full
72-layer jamba, 398.6 B params; deepseek-v2-236b, 235.7 B;
llama-3.2-vision-90b, 87.7 B; granite-34b, 47.2 B) are not cut here: on
a card their init fails with the allocator's out-of-memory error
(chip_smoke.py serves cuts in depth).

Params are random (seed 0), in the config's compute dtype.

``--st-mode st|host|fused`` routes the decode step's collectives
through scheduled triggered-op programs (repro_torch.serving.st_decode),
one cached schedule per active-slot bucket, on ``--st-ranks`` virtual
ranks of the device; ``--st-config auto`` resolves each bucket's
schedule from the tuned cache (``--tuned``, default
``results/tuned_torch.json``; autotuning on a miss), ``--st-config
default`` pins the default ScheduleConfig, and a JSON object gives one.
rwkv6-1.6b keeps no KV rows and refuses ``--st-mode``, as the
reference does.

  python -m repro_torch.launch.serve --arch granite-3-2b --st-mode st \
      --st-ranks 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--moe-impl", default="dense",
                    choices=["dense", "gshard", "a2a"])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--st-mode", default=None,
                    choices=["st", "host", "fused"],
                    help="route decode collectives through scheduled "
                         "triggered-op programs (default: the baseline)")
    ap.add_argument("--st-config", default="auto",
                    help="'auto' (tuned cache), 'default', or a "
                         "ScheduleConfig JSON object")
    ap.add_argument("--tuned", default=None,
                    help="tuned-cache path for --st-config auto")
    ap.add_argument("--st-ranks", type=int, default=1,
                    help="virtual ranks of the decode collective")
    args = ap.parse_args()

    from repro_torch.configs import get_config
    from repro_torch.core.compat import resolve_device
    from repro_torch.models import init_params, model_specs
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(model_specs(cfg), gen, device,
                         getattr(torch, cfg.compute_dtype))
    st_config = args.st_config
    if st_config == "default":
        from repro_torch.core.autotune import ScheduleConfig
        st_config = ScheduleConfig()
    elif st_config != "auto":
        import json
        from repro_torch.core.autotune import ScheduleConfig
        st_config = ScheduleConfig.from_dict(json.loads(st_config))
    eng = ServingEngine(cfg, params, batch_slots=args.slots,
                        max_len=args.max_len, moe_impl=args.moe_impl,
                        st_mode=args.st_mode, st_config=st_config,
                        tuned_path=args.tuned, st_ranks=args.st_ranks,
                        device=device)

    rng = np.random.RandomState(0)
    t0 = time.time()
    for _ in range(args.requests):
        L = rng.randint(4, 16)
        eng.submit(Request(prompt=rng.randint(1, cfg.vocab_size, L)
                           .astype(np.int32),
                           max_new_tokens=args.max_new))
    steps = eng.run_until_drained()
    dt = time.time() - t0
    new_toks = sum(len(r.out_tokens) for r in eng.completed)
    lat = [r.done_at - r.submitted_at for r in eng.completed]
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"served {len(eng.completed)} requests, {new_toks} tokens in "
          f"{dt:.2f}s over {steps} engine steps "
          f"({new_toks/max(dt,1e-9):.1f} tok/s) on {name}")
    print(f"latency p50={np.percentile(lat,50)*1e3:.0f}ms "
          f"p99={np.percentile(lat,99)*1e3:.0f}ms")
    if args.st_mode:
        st = eng.stats()["st"]
        buckets = {b: m["dispatches"] for b, m in st["buckets"].items()}
        print(f"st decode path: mode={st['mode']} pattern={st['pattern']}"
              f" dispatches per slot bucket {buckets}")


if __name__ == "__main__":
    main()
