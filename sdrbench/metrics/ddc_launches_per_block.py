"""Calls of the CUDA launch API on the host that start inside
``sdrtpu.rx.ddc``, the per-VFO DDCs (mixer and resampler of each VFO
outside a fused group), over the traced window, per block completed in
it (`sdrbench.spans`)."""

from sdrbench import spans


def read(run):
    return spans.launches_per_block(run, "sdrtpu.rx.ddc")
