"""Model FLOPs of the window's decode steps (closed form: every active
slot's token at its own position, each MoE layer at the experts it
routes to, not the 16 a dense MoE computes; idle slots not counted) over
the steps' time and the bf16 peak, in %."""
from stbench.counts import PEAK_BF16_FLOPS


def read(rec):
    s = rec["stats"].get("decode_seconds")
    return 100.0 * rec["decode_flops"] / (s * PEAK_BF16_FLOPS) if s \
        else None
