"""The flash attention kernel's share of its roofline over the traced
prefill dispatches, in %: causal FLOPs and q, k, v, output bytes of each
dispatch's rows x length (stbench/counts.py)."""
from stbench.kernel_share import share


def read(rec):
    a = rec.get("attention")
    return share(rec["trace"], a["flash"]) if a else None
