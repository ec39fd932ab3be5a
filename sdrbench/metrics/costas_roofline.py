"""The Costas scan's (``costas_scan``) share of its roofline: the least
time one launch's function needs at its shape (`frozen.scan_counts`)
against the published peaks (`frozen.peaks`), over the profiler's mean
device time per launch, in percent.

A launch's samples are the decoder VFO's samples of the traced window's
blocks over the program's own count of launches in it.  The scan is a
chain of dependent steps, so the share is tiny: its practical bound is
the chain's latency, not the roofline."""

from sdrbench import roofline
from sdrbench.frozen import scan_counts


def read(run):
    def work(tr, launches, shapes):
        n = tr.blocks * shapes["if_len"] / launches
        return scan_counts.costas_scan(n)
    return roofline.share(run, "costas_scan", "costas_scan", work)
