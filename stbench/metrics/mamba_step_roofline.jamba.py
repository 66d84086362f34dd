"""The Mamba decode scan kernel's (``mamba_scan_step``) share of its
roofline over the traced decode steps, in %: per active slot the state
read and written once, dt, x, B, C read and y written, A read once a
launch (stbench/counts_jamba.py)."""
from stbench.kernel_share import share


def read(rec):
    k = rec.get("kernels")
    return share(rec["trace"], k["mamba_step"]) \
        if k and "mamba_step" in k else None
