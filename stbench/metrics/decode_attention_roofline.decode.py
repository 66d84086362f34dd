"""The decode attention kernels' (split pass and merge) share of their
roofline over the traced decode steps, in %: bytes of the active slots'
valid KV rows, their queries and outputs (stbench/counts.py)."""
from stbench.kernel_share import share


def read(rec):
    a = rec.get("attention")
    return share(rec["trace"], a["decode"]) if a else None
