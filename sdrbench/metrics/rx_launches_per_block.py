"""Calls of the CUDA launch API on the host that start inside
``sdrtpu.rx.frontend``, the receiver's frontend call (waterfall, fused
channelizers, per-VFO DDCs, radio chains), over the traced window, per
block completed in it (`sdrbench.spans`)."""

from sdrbench import spans


def read(run):
    return spans.launches_per_block(run, "sdrtpu.rx.frontend")
