"""Filter and window design of SDR++, in float64 NumPy.

The plain reference designs its own taps from a configuration's rates and
widths with these formulas, so it takes no table from the program.  They
are SDR++'s (``core/src/dsp/taps/{windowed_sinc,estimate_tap_count,
low_pass,band_pass}.h``, ``core/src/dsp/window/{cosine,nuttall}.h``),
written out from the published C++ and kept here unchanged:

- a tap count is ``int(3.8 * samplerate / transition_width)``;
- tap ``i`` sits at the centred time ``t = i - count/2 + 0.5``;
- the window is the cosine sum ``sum_k (-1)^k c_k cos(2 pi k n / N)``
  evaluated at ``n = t - count/2``;
- ``sinc(x) = sin(x)/x``.

The multistage plan of an integer decimation (largest factors first,
each stage passing 40 % of the final rate) is the program's documented
design rule (``RationalResampler``'s pre-decimation), restated here.
"""

from __future__ import annotations

import math

import numpy as np

NUTTALL = (0.355768, 0.487396, 0.144232, 0.012604)


def cosine_window(n, N: float, coefs=NUTTALL) -> np.ndarray:
    n = np.asarray(n, np.float64)
    return sum(((-1.0) ** k) * c * np.cos(2.0 * np.pi * k * n / N)
               for k, c in enumerate(coefs))


def tap_count(trans_width: float, samplerate: float,
              odd: bool = False) -> int:
    count = int(3.8 * samplerate / trans_width)
    return count + 1 if odd and count % 2 == 0 else count


def _centred(count: int) -> np.ndarray:
    return np.arange(count, dtype=np.float64) - count / 2.0 + 0.5


def low_pass(cutoff: float, trans_width: float, samplerate: float,
             odd: bool = False) -> np.ndarray:
    """Nuttall windowed-sinc lowpass, float64."""
    count = tap_count(trans_width, samplerate, odd)
    omega = 2.0 * np.pi * cutoff / samplerate
    t = _centred(count)
    return (np.sinc(t * omega / np.pi) * cosine_window(t - count / 2.0, count)
            * omega / np.pi)


def band_pass_complex(start: float, stop: float, trans_width: float,
                      samplerate: float, odd: bool = False) -> np.ndarray:
    """Analytic bandpass: a half-width lowpass moved to the band's centre
    through its window, complex128."""
    count = tap_count(trans_width, samplerate, odd)
    centre = 2.0 * np.pi * (start + stop) / 2.0 / samplerate
    omega = 2.0 * np.pi * (stop - start) / 2.0 / samplerate
    t = _centred(count)
    n = t - count / 2.0
    return (np.sinc(t * omega / np.pi) * np.exp(-1j * centre * n)
            * cosine_window(n, count) * omega / np.pi)


def decimation_plan(in_rate: float, ratio: int,
                    out_bw: float) -> list[tuple[int, np.ndarray]]:
    """Integer decimation as stages [(factor, taps)], largest factors
    first; each stage passes ``out_bw`` and stops at the next stage's
    folding edge."""
    factors, d = [], int(ratio)
    for p in (8, 7, 6, 5, 4, 3, 2):
        while d % p == 0 and d > 1:
            factors.append(p)
            d //= p
    if d > 1:
        factors.append(d)
    factors.sort(reverse=True)
    stages, r = [], float(in_rate)
    for f in factors:
        r_next = r / f
        stop = r_next - out_bw
        trans = max(stop - out_bw, 0.05 * r_next)
        cutoff = min((out_bw + stop) / 2.0, 0.45 * r_next)
        stages.append((f, low_pass(cutoff, trans, r)))
        r = r_next
    return stages


def rational(in_rate: float, out_rate: float) -> tuple[int, int]:
    """(interp, decim) of a rational rate change, reduced."""
    a, b = round(in_rate), round(out_rate)
    g = math.gcd(a, b)
    return b // g, a // g


def polyphase_bank(interp: int, taps: np.ndarray) -> np.ndarray:
    """(interp, taps_per_phase): ``bank[p, t] = taps[t*interp +
    interp-1-p]``, zero past the end."""
    tpp = -(-len(taps) // interp)
    padded = np.zeros(interp * tpp)
    padded[:len(taps)] = taps
    return padded.reshape(tpp, interp)[:, ::-1].T.copy()


def fm_subcarrier_comp(if_rate: float) -> float:
    """Gain that flattens the discriminator's sinc droop over the 38 kHz
    subcarrier's 0-15 kHz sidebands: 2 / (max + min) of the droop."""
    f = np.linspace(0.0, 15000.0, 301)
    gain = 0.5 * (np.sinc((38000.0 - f) / if_rate)
                  + np.sinc((38000.0 + f) / if_rate))
    return 2.0 / (gain.max() + gain.min())


def spectrum_window(nz: int, fft_size: int) -> np.ndarray:
    """The waterfall's periodic Nuttall window over ``nz`` samples, with
    the (-1)^i centring of an even transform folded in."""
    i = np.arange(nz, dtype=np.float64)
    w = cosine_window(i - float(nz), nz)
    if fft_size % 2 == 0:
        w = w * (-1.0) ** i
    return w
