"""Expert rows the MoE layers computed over the rows their tokens were
routed to, in the window (the engine's ``moe_rows_computed`` over
``moe_rows_routed``): 64/6 = 10.67 for a 64-expert top-6 dense MoE with
every decode slot active, 1 for a dropless gathered one."""


def read(rec):
    s = rec["stats"]
    if not s.get("moe_rows_routed"):
        return None
    return s["moe_rows_computed"] / s["moe_rows_routed"]
