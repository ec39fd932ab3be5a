"""95th percentile over the window's blocks of the time from a block's
due time until all its outputs are on the host."""

import numpy as np


def read(run):
    if not run.latency_s:
        return None
    return float(np.percentile(run.latency_s, 95)) * 1e3
