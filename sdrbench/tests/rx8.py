"""The ``rx8.stream`` cell cut to a size the CPU runs in seconds: the
capture at 2 Msps, every VFO and spare station at its offset scaled by
the same factor (multiples of 20 kHz, so every oscillator still completes
whole cycles in a block), 400 000-sample blocks (still 200 ms), an
8192-bin waterfall.  Every mode, IF rate and audio rate is kept."""

from sdrbench import harness

FS = 2e6


def scaled(cfg: dict, fs: float = FS) -> dict:
    """``cfg`` (changed in place) at the samplerate ``fs``."""
    k = fs / cfg["samplerate"]
    cfg.update(samplerate=fs, block_len=round(cfg["block_len"] * k),
               fft_size=8192)
    cfg["vfos"] = [dict(v, offset_hz=v["offset_hz"] * k) for v in cfg["vfos"]]
    cap = cfg["capture"]
    cap["spare"] = [dict(v, offset_hz=v["offset_hz"] * k)
                    for v in cap["spare"]]
    return cfg


def tiny_cell(root=harness.ROOT) -> dict:
    """The cell at `FS`, a 1.2 s capture (6 blocks), one warm-up call and
    three checked blocks."""
    cell = harness.load_cell("rx8.stream", root)
    scaled(cell["config"])
    cell["traffic"].update(capture_s=1.2, warmup_calls=1, check_blocks=3)
    return cell
