"""Calls of the CUDA launch API on the host that start inside
``sdrtpu.waterfall``, the waterfall (window, FFT, power, dB), over the
traced window, per block completed in it (`sdrbench.spans`)."""

from sdrbench import spans


def read(run):
    return spans.launches_per_block(run, "sdrtpu.waterfall")
