"""The window's length over the Faces iterations completed in it, in
ms (programs called back to back, each ending in its host sync)."""


def read(rec):
    its = rec["programs"] * rec["iterations_per_program"]
    return 1e3 * rec["window_s"] / its if its else None
