"""One stereo FM broadcast station at each VFO offset, plus white noise.

The pattern is ``chip_smoke.py``'s ``stereo_capture`` at commit
794db71f23cf1f26fdc4edce6acfb7756f4932c5 (itself the one of
``tests/test_scan_call.py``): left and right tones, a 19 kHz pilot at
10 % and the 38 kHz L-R subcarrier,

    mpx = 0.45 (L + R) + 0.1 sin(2 pi 19 kHz t) + 0.45 (L - R) sin(2 pi 38 kHz t)

frequency-modulated at 75 kHz deviation.  Here each station's two tones
and their phases are drawn from the seed, and complex white noise is
added, all on ``device`` with one ``torch.Generator``: every seed makes
the same amount of work with other content.
"""

from __future__ import annotations

import numpy as np
import torch


def make(cfg: dict, n: int, seed: int, device) -> torch.Tensor:
    cap = cfg["capture"]
    fs = float(cfg["samplerate"])
    span = float(cfg["vfo_span"])
    offsets = np.linspace(-span * fs, span * fs, int(cfg["vfos"]))
    lo, hi = cap["tone_hz"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    f64 = dict(dtype=torch.float64, device=device)
    draws = torch.rand((len(offsets), 4), generator=gen, **f64)
    tones = lo + (hi - lo) * draws[:, :2]
    phases = 2.0 * np.pi * draws[:, 2:]
    noise = torch.randn((2, n), generator=gen, dtype=torch.float32,
                        device=device) * float(cap["noise_rms"])
    x = torch.complex(noise[0], noise[1]).to(torch.complex128)
    del noise
    t = torch.arange(n, **f64) / fs
    w = 2.0 * np.pi * t
    dev = float(cap["deviation_hz"])
    for i, fc in enumerate(offsets):
        left = torch.sin(w * tones[i, 0] + phases[i, 0])
        right = torch.sin(w * tones[i, 1] + phases[i, 1])
        mpx = (0.45 * (left + right) + 0.1 * torch.sin(w * 19000.0)
               + 0.45 * (left - right) * torch.sin(w * 38000.0))
        del left, right
        phase = torch.cumsum(mpx, 0) * (2.0 * np.pi * dev / fs)
        del mpx
        # the carrier's angle reduced to one turn before the float64 sine
        cyc = torch.remainder(torch.arange(n, **f64) * fc, fs) / fs
        x += float(cap["amplitude"]) * torch.polar(
            torch.ones_like(phase), 2.0 * np.pi * cyc + phase)
        del phase, cyc
    return x.to(torch.complex64)
