"""The M&M timing scan's (``mm_scan``) share of its roofline: the least
time one launch's function needs at its shape (`frozen.scan_counts`:
the samples, the symbol slots and the interpolator bank, the symbols at
the nominal rate) against the published peaks, over the profiler's mean
device time per launch, in percent.  A launch's samples: the decoder
VFO's samples of the traced window's blocks over the program's count of
launches."""

from sdrbench import roofline
from sdrbench.frozen import scan_counts


def read(run):
    def work(tr, launches, shapes):
        n = tr.blocks * shapes["if_len"] / launches
        return scan_counts.mm_scan(
            n, shapes["max_out"], n / shapes["sps"], shapes["mm_phases"],
            shapes["mm_taps"])
    return roofline.share(run, "mm_scan", "mm_scan", work)
