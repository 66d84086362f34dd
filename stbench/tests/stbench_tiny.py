"""Tiny cells for the CPU tests: the repository's cells with their
sizes cut so that a run takes seconds on the CPU."""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from stbench import harness  # noqa: E402

# the tiny decoder's widest gap reads 0.0009 to 0.0075 in bf16 on the CPU,
# its float8 control 0.064 to 0.135, over 8 requests of 24 tokens on ten
# seeds (test_stbench_control.py); head dim 32 has a kernel on the card
TINY_GAP_LIMIT = 0.025


def _load(rel):
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def faces_overrides():
    config = dict(_load("stbench/configs/faces-64r.json"), grid=[2, 2, 2])
    mix = dict(_load("stbench/traffic/halo-n64.json"), n=[4, 4, 4],
               check_states=2, trace_after_s=0.0)
    return {"config": config, "mix": mix}


def serve_overrides():
    config = _load("stbench/configs/granite-3-2b.json")
    config["model"].update(hidden_size=128, intermediate_size=256,
                           num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2, head_dim=32,
                           vocab_size=2048, attention_multiplier=32 ** -0.5)
    config["serving"].update(slots=4, max_len=64)
    mix = dict(_load("stbench/traffic/reasoning-decode.json"), clients=4,
               prompt_tokens={"uniform": [4, 12]},
               output_tokens={"uniform": [8, 24]}, check_requests=64,
               trace_after_s=0.0, trace_seconds=0.5)
    return {"config": config, "mix": mix,
            "limits": {"max_logit_gap": TINY_GAP_LIMIT}}


def run_tiny(workload, overrides, seed=20260101, seconds=1.5):
    """One run of ``workload`` at the tiny size on the CPU, past the
    harness's look for a card: (result line, checks)."""
    import torch
    return harness.run_cell(harness.load_benchmark(), workload, seed=seed,
                            seconds=seconds, trace=False,
                            device=torch.device("cpu"),
                            t_start=time.perf_counter(),
                            overrides=overrides)
