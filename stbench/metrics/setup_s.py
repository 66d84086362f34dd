"""Process start to the first timed operation: program build, weights
or state, warm-up and graph captures (and, in a checkout's first run,
the kernels' compilation)."""


def read(rec):
    return rec["setup_s"]
