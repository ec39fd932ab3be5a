"""Calls of the CUDA launch API on the host that start inside
``sdrtpu.if_back_end``, the IF back end (demod, audio resampler, de-
emphasis), over the traced window, per block completed in it
(`sdrbench.spans`)."""

from sdrbench import spans


def read(run):
    return spans.launches_per_block(run, "sdrtpu.if_back_end")
