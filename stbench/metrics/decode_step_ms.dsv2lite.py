"""Host ms a decode step, ids back on the host (the engine's
``decode_seconds`` over its ``decode_steps``, in the window)."""


def read(rec):
    s = rec["stats"]
    return 1e3 * s["decode_seconds"] / s["decode_steps"] \
        if s.get("decode_steps") else None
