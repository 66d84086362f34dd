"""Host ms of the ST router a decode step (the engine's
``st_dispatch_seconds`` over its ``decode_steps``, in the window): the
latent rows, the ids and the hidden blocks staged, the program, the ids
back."""


def read(rec):
    s = rec["stats"]
    if not s.get("decode_steps") or "st_dispatch_seconds" not in s:
        return None
    return 1e3 * s["st_dispatch_seconds"] / s["decode_steps"]
