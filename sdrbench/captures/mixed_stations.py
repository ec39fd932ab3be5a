"""One station at each VFO of the mixed receiver and at each spare offset
beside them, plus white noise.

The stations are shaped as ``chip_smoke.py``'s ``rx_station`` at commit
794db71f23cf1f26fdc4edce6acfb7756f4932c5, by mode:

- wfm: stereo FM, ``mpx = 0.45 (L + R) + 0.1 sin(2 pi 19 kHz t) +
  0.45 (L - R) sin(2 pi 38 kHz t)`` at 75 kHz deviation;
- nfm: one tone at 2.5 kHz deviation;
- am: the carrier times ``1 + 0.5 sin(2 pi f t)``;
- usb: one tone ``f`` above the carrier;
- cw: the carrier itself, a few tens of Hz off the VFO.

Here every tone, phase and CW offset is drawn from the seed, and complex
white noise is added, all on ``device`` with one ``torch.Generator``:
every seed makes the same amount of work with other content.
"""

from __future__ import annotations

import numpy as np
import torch


def make(cfg: dict, n: int, seed: int, device) -> torch.Tensor:
    cap = cfg["capture"]
    fs = float(cfg["samplerate"])
    stations = list(cfg["vfos"]) + list(cap["spare"])
    lo, hi = cap["tone_hz"]
    cw_lo, cw_hi = cap["cw_offset_hz"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    f64 = dict(dtype=torch.float64, device=device)
    draws = torch.rand((len(stations), 5), generator=gen, **f64).tolist()
    noise = torch.randn((2, n), generator=gen, dtype=torch.float32,
                        device=device) * float(cap["noise_rms"])
    x = torch.complex(noise[0], noise[1]).to(torch.complex128)
    del noise
    k = torch.arange(n, **f64)
    w = 2.0 * np.pi * k / fs
    for st, (u1, u2, p1, p2, u3) in zip(stations, draws):
        f1, f2 = lo + (hi - lo) * u1, lo + (hi - lo) * u2
        p1, p2 = 2.0 * np.pi * p1, 2.0 * np.pi * p2
        one = torch.sin(w * f1 + p1)
        mode = st["mode"]
        if mode == "wfm":
            two = torch.sin(w * f2 + p2)
            mpx = (0.45 * (one + two) + 0.1 * torch.sin(w * 19000.0)
                   + 0.45 * (one - two) * torch.sin(w * 38000.0))
            del two
            angle = torch.cumsum(mpx, 0) * (
                2.0 * np.pi * float(cap["wfm_deviation_hz"]) / fs)
            base = torch.polar(torch.ones_like(angle), angle)
            del mpx, angle
        elif mode == "nfm":
            angle = torch.cumsum(one, 0) * (
                2.0 * np.pi * float(cap["nfm_deviation_hz"]) / fs)
            base = torch.polar(torch.ones_like(angle), angle)
            del angle
        elif mode == "am":
            base = (1.0 + float(cap["am_depth"]) * one).to(torch.complex128)
        elif mode == "usb":
            base = torch.polar(torch.ones_like(one), w * f1 + p1)
        elif mode == "cw":
            base = torch.polar(torch.ones_like(one),
                               w * (cw_lo + (cw_hi - cw_lo) * u3))
        else:
            raise ValueError(f"no station shape for mode {mode!r}")
        del one
        # the carrier's angle reduced to one turn before the float64 sine
        cyc = torch.remainder(k * float(st["offset_hz"]), fs) / fs
        x += float(cap["amplitude"]) * base * torch.polar(
            torch.ones_like(cyc), 2.0 * np.pi * cyc)
        del base, cyc
    return x.to(torch.complex64)
