"""A kernel group's share of its roofline from a traced run: the bound
of the launches the trace holds over their device time, in %.

``group``: {"names": device functions, "bound_s": bound seconds of the
``launches`` launches the traced work made}. Where the trace lost
events, the bound is scaled to the launches it holds, so a share is of
measured work only. None where the trace holds none of them."""
from stbench.devtrace import kernel_stats


def share(red: dict, group: dict):
    seen, secs = kernel_stats(red, group["names"])
    if not seen or not secs or not group["launches"]:
        return None
    bound = group["bound_s"] * min(seen, group["launches"]) \
        / group["launches"]
    return 100.0 * bound / secs
