"""Calls of the CUDA launch API on the host that start inside
``sdrtpu.rx.demod``, the decoder VFO's demodulator (RRC, FastAGC, Costas
and M&M), over the traced window, per block completed in it
(`sdrbench.spans`)."""

from sdrbench import spans


def read(run):
    return spans.launches_per_block(run, "sdrtpu.rx.demod")
