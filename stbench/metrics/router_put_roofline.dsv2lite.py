"""The ST router's put kernels' (``put_signal``: the latent rows, token
ids and the hidden block to each peer shift) share of their roofline
over the traced decode steps, in %: each staged row read once and
written once to its peer, on every rank (stbench/counts_deepseek.py)."""
from stbench.kernel_share import share


def read(rec):
    k = rec.get("kernels")
    return share(rec["trace"], k["router_put"]) \
        if k and "router_put" in k else None
