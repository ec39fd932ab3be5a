"""Host time inside ``sdrtpu.rx.ddc``, the per-VFO DDCs, over the traced
window, per block completed in it, in ms (`sdrbench.spans`).  Timed
under the profiler, which adds to every operation: compare it with
traced runs only."""

from sdrbench import spans


def read(run):
    return spans.host_ms_per_block(run, "sdrtpu.rx.ddc")
