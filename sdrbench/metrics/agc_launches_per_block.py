"""Launches of the AGC scan (``agc_scan``) per block over the traced
window, from the program's own counter (``agc_scan.launches``): the
profiler's trace drops back-to-back scan launches, so the trace cannot
count them."""


def read(run):
    tr = run.traced
    if tr is None or not tr.blocks:
        return None
    n = tr.counters.get("agc_scan.launches")
    return None if n is None else n / tr.blocks
