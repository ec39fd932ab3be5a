"""The Viterbi decoder's (``viterbi_decode``) share of its roofline: the
least time one launch's function needs at its shape (`frozen.scan_counts`:
64 states, rate 1/2) against the published peaks, over the profiler's
mean device time per launch, in percent.  A launch's trellis steps: the
deframer's own count of steps decoded in the traced window (the carried
tail's again) over the program's count of launches."""

from sdrbench import roofline
from sdrbench.frozen import scan_counts


def read(run):
    def work(tr, launches, shapes):
        steps = tr.counters.get("deframe.viterbi_steps")
        if not steps:
            return None
        return scan_counts.viterbi_decode(steps / launches)
    return roofline.share(run, "viterbi_decode", "viterbi", work)
