"""Median over the window's blocks of the time from a block's due time
(its last sample's arrival at the radio's rate) until all its outputs
are on the host."""

import numpy as np


def read(run):
    if not run.latency_s:
        return None
    return float(np.percentile(run.latency_s, 50)) * 1e3
