"""95th percentile (linear between order statistics) of the time to
first token of every request sent in the window, in ms."""
import numpy as np


def read(rec):
    return 1e3 * float(np.percentile(rec["ttft_s"], 95)) \
        if rec["ttft_s"] else None
