"""Model FLOPs of the window's decode steps (closed form,
stbench/counts_deepseek.py: every active slot's token at its own
position, MLA absorbed over that slot's valid rows, each MoE layer at
its 6 routed and 2 shared experts, not the 64 a dense MoE computes; idle
slots not counted) over the steps' time and the bf16 peak, in %."""
from stbench.counts import PEAK_BF16_FLOPS


def read(rec):
    s = rec["stats"].get("decode_seconds")
    return 100.0 * rec["decode_flops"] / (s * PEAK_BF16_FLOPS) if s \
        else None
