"""95th percentile (linear between order statistics) of every
inter-token gap of every request in the window, in ms."""
import numpy as np


def read(rec):
    return 1e3 * float(np.percentile(rec["itl_s"], 95)) if rec["itl_s"] \
        else None
