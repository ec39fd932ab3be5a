"""Host time inside ``sdrtpu.deframe``, the deframer's call (the Viterbi
launch, the wait for it, the bits' copy to the host, the ASM search and
the Reed-Solomon decodes), over the traced window, per block completed
in it, in ms (`sdrbench.spans`).  Timed under the profiler: compare it
with traced runs only."""

from sdrbench import spans


def read(run):
    return spans.host_ms_per_block(run, "sdrtpu.deframe")
