"""Calls of the CUDA launch API on the host over the traced window,
per block completed in it."""


def read(run):
    tr = run.traced
    if tr is None or not tr.blocks or not tr.trace.launches:
        return None
    return tr.trace.launches / tr.blocks
