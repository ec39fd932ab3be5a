"""The ``meteor.batch`` cell cut to a size the CPU runs in seconds: the
front end at 600 ksps with the VFO at +75 kHz (the offset scaled with
the rate), every rate from the VFO down kept (150 ksps, 72 ksym/s),
50 ms blocks (the Costas and M&M scans run their plain loops on the CPU,
~0.3 ms a step), a 2 s capture and an 8192-bin waterfall."""

from sdrbench import harness

FS = 600000.0
BLOCK_S = 0.05


def scaled(cfg: dict, fs: float = FS, block_s: float = BLOCK_S) -> dict:
    """``cfg`` (changed in place) at the samplerate ``fs``."""
    k = fs / cfg["samplerate"]
    cfg.update(samplerate=fs, block_len=round(fs * block_s), fft_size=8192)
    cfg["vfos"] = [dict(v, offset_hz=v["offset_hz"] * k) for v in cfg["vfos"]]
    return cfg


def tiny_cell(root=harness.ROOT) -> dict:
    """The cell at `FS`: a 2 s capture (40 blocks), a call of three blocks
    (one warm-up call, one in the window: three checked blocks, one of
    each place in a call), the reference warmed over 8 blocks (0.4 s,
    past the deframer's lock, which can take three frames)."""
    cell = harness.load_cell("meteor.batch", root)
    scaled(cell["config"])
    cell["traffic"].update(capture_s=2.0, blocks_per_call=3, warmup_calls=1,
                           check_blocks=3, warm_blocks=8)
    return cell
