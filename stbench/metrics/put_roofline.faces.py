"""The put kernels' share of their roofline in the traced Faces
programs (bytes in closed form, stbench/counts.py), in %."""
from stbench.kernel_share import share


def read(rec):
    n = rec.get("traced_programs")
    if not n:
        return None
    k = rec["kernels"]["put"]
    its = n * rec["iterations_per_program"]
    return share(rec["trace"], {"names": k["names"],
                                "bound_s": k["bound_s_per_iteration"] * its,
                                "launches": k["launches_per_iteration"] * its})
