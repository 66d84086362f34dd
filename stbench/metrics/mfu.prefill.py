"""Model FLOPs of the window's prefill dispatches (closed form, causal,
the last position's logits) over their time and the bf16 peak, in %."""
from stbench.counts import PEAK_BF16_FLOPS


def read(rec):
    s = rec["stats"].get("prefill_seconds")
    return 100.0 * rec["prefill_flops"] / (s * PEAK_BF16_FLOPS) \
        if s else None
