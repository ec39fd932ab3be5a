"""Signal seconds completed per wall second over the whole window: the
blocks whose every output reached the host, as seconds of the capture,
over the window's length.  How many real-time captures one card serves."""


def read(run):
    if not run.window_s or not run.blocks:
        return None
    return run.blocks * run.block_len / run.samplerate / run.window_s
