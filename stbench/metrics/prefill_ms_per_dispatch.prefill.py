"""Host ms a prefill dispatch, ids back on the host (the engine's
``prefill_seconds`` over its ``prefill_dispatches``, in the window)."""


def read(rec):
    s = rec["stats"]
    return 1e3 * s["prefill_seconds"] / s["prefill_dispatches"] \
        if s.get("prefill_dispatches") else None
