"""Host CUDA calls that put work on the device (graph and kernel
launches, async copies and memsets) per Faces program, in the trace."""


def read(rec):
    n = rec.get("traced_programs")
    if not n:
        return None
    return sum(rec["trace"]["host_calls"].values()) / n
