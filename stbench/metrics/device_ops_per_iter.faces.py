"""Device operations (kernels, copies, memsets; the graph's state copies
in and out included) per Faces iteration, in the trace."""


def read(rec):
    n = rec.get("traced_programs")
    if not n:
        return None
    ops = sum(c for c, _ in rec["trace"]["device_ops"].values())
    return ops / (n * rec["iterations_per_program"])
