"""Host time inside ``sdrtpu.rx.demod``, the decoder VFO's demodulator,
over the traced window, per block completed in it, in ms
(`sdrbench.spans`).  Timed under the profiler, which adds to every
operation: compare it with traced runs only."""

from sdrbench import spans


def read(run):
    return spans.host_ms_per_block(run, "sdrtpu.rx.demod")
