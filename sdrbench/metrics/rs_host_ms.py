"""Host time inside ``sdrtpu.deframe.rs``, the Reed-Solomon decodes of
the frames' four codewords, over the traced window, per block completed
in it, in ms (`sdrbench.spans`).  Timed under the profiler: compare it
with traced runs only."""

from sdrbench import spans


def read(run):
    return spans.host_ms_per_block(run, "sdrtpu.deframe.rs")
