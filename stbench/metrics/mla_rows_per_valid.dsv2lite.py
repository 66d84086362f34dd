"""Latent cache rows the absorbed MLA decode scored over the valid rows
among them, in the window (the engine's ``mla_rows_scored`` over
``mla_rows_valid``): every slot's ``max_len`` rows a step against each
active slot's position + 1; 1 for a decode that reads only the valid
rows of the active slots. None where the engine has no such counters."""


def read(rec):
    s = rec["stats"]
    if not s.get("mla_rows_valid"):
        return None
    return s["mla_rows_scored"] / s["mla_rows_valid"]
