"""Training launcher of the port, following the JAX package's
``launch/train.py``:

  python -m repro_torch.launch.train --arch granite-3-2b --reduced \\
      --steps 200 --seq 128 --batch 8 --ckpt-dir "${TMPDIR:-/tmp}/ckpt"

It wires config -> float32 master params and optimizer state on the
device -> synthetic data pipeline -> train step -> fault-tolerant
runtime (periodic async checkpoints, preemption-safe, resume from the
newest complete step with ``--resume``). The device is the card unless
``--device cpu`` asks for the CPU. ``--reduced`` runs the arch's reduced
config with ``grad_accum=1``, as the reference's does. Checkpoints go to
``--ckpt-dir``, by default ``repro_torch_ckpt`` under the temporary
directory (``TMPDIR``); ``--resume`` takes the newest complete step
found there, whichever run wrote it, and says which directory it read.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--moe-impl", default="dense")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.compat import resolve_device
    from repro_torch.data import SyntheticTokens, make_batch_iterator
    from repro_torch.models import (init_params, model_specs, param_count,
                                    trainable)
    from repro_torch.optim import cosine_schedule, opt_init
    from repro_torch.runtime import TrainingRuntime
    from repro_torch.train.steps import make_train_step

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, grad_accum=1)
    specs = model_specs(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = trainable(init_params(specs, gen, device=device))
    opt = opt_init(cfg, params)
    print(f"arch={cfg.name} params={param_count(specs):,} "
          f"vocab={cfg.vocab_size}")

    sched = lambda s: cosine_schedule(s, peak_lr=args.lr, warmup=20,
                                      total=args.steps)
    step_raw = make_train_step(cfg, moe_impl=args.moe_impl, schedule=sched)

    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=0)
    rt = TrainingRuntime(args.ckpt_dir, ckpt_every=args.ckpt_every,
                         install_signal_handlers=True)
    state = {"params": params, "opt": opt}
    start = 0
    if args.resume:
        state, start, _ = rt.maybe_restore(state, device)
        print(f"resumed at step {start} from {args.ckpt_dir}")

    def step_fn(state, batch):
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        p, o, m = step_raw(state["params"], state["opt"], b)
        return {"params": p, "opt": o}, m

    it = make_batch_iterator(ds, start_step=start)
    t0 = time.time()
    state, step, preempted = rt.run(state, it, step_fn, start_step=start,
                                    total_steps=args.steps,
                                    log_every=args.log_every)
    it.close()
    dt = time.time() - t0
    toks = (step - start) * args.batch * args.seq
    print(f"done: {step - start} steps in {dt:.1f}s "
          f"({toks/max(dt,1e-9):.0f} tok/s)"
          f"{' [preempted]' if preempted else ''}")


if __name__ == "__main__":
    main()
