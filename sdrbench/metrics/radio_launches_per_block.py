"""Calls of the CUDA launch API on the host that start inside
``sdrtpu.rx.radio``, the VFOs' radio chains (demodulator, AGC, audio
resampler, de-emphasis), over the traced window, per block completed in
it (`sdrbench.spans`)."""

from sdrbench import spans


def read(run):
    return spans.launches_per_block(run, "sdrtpu.rx.radio")
