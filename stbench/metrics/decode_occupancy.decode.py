"""Mean active slots per decode step over the window, from the
harness's step records."""


def read(rec):
    steps = rec["stats"].get("decode_steps")
    return rec["occupancy"] / steps if steps else None
