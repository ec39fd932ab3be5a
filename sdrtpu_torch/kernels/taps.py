"""FIR tap design (design-time, NumPy float64 → float32).

Reimplements the *math* of the reference's tap designers —
``core/src/dsp/taps/{windowed_sinc,estimate_tap_count,low_pass,high_pass,
band_pass,root_raised_cosine,raised_cosine}.h`` — as vectorized NumPy.  Tap
design runs on the host at configuration time; the resulting float32 (or
complex64) arrays are closed over by jitted kernels as constants.

Conventions (identical to the reference):
- ``t = i - count/2 + 0.5`` is the centered time index of tap ``i``.
- The window is evaluated at ``t - count/2`` (an interval spanning
  ``[-count, 0]``) with the centered cosine-sum windows in `windows.py`.
- ``sinc(x) = sin(x)/x`` (unnormalized, radians).
- Tap count estimate: ``3.8 * samplerate / transition_width``
  (``estimate_tap_count.h:4-6``).
"""

from __future__ import annotations

import numpy as np

from .windows import COSINE_COEFS, cosine_window


def estimate_tap_count(trans_width: float, samplerate: float) -> int:
    """Tap-count heuristic, per reference ``estimate_tap_count.h``."""
    return int(3.8 * samplerate / trans_width)


def _sinc(x: np.ndarray) -> np.ndarray:
    """Unnormalized sinc: sin(x)/x with sinc(0)=1 (``math/sinc.h``)."""
    return np.sinc(x / np.pi)


def hz_to_rads(freq: float, samplerate: float) -> float:
    """Normalized angular frequency: 2*pi*f/fs (``math/hz_to_rads.h``)."""
    return 2.0 * np.pi * (freq / samplerate)


def windowed_sinc(
    count: int,
    omega: float,
    window: str = "nuttall",
    norm: float = 1.0,
    window_fn=None,
) -> np.ndarray:
    """Windowed-sinc lowpass prototype (``windowed_sinc.h:9-28``).

    ``omega`` is the normalized angular cutoff (rad/sample).  ``window_fn``,
    if given, overrides the named window: called as ``window_fn(n, N)`` with
    centered ``n`` spanning ``[-count, 0)``.
    """
    i = np.arange(count, dtype=np.float64)
    half = count / 2.0
    t = i - half + 0.5
    corr = norm * omega / np.pi
    if window_fn is None:
        coefs = COSINE_COEFS[window]
        win = cosine_window(t - half, count, coefs)
    else:
        win = window_fn(t - half, count)
    return (_sinc(t * omega) * win * corr).astype(np.float32)


def low_pass(
    cutoff: float, trans_width: float, samplerate: float, odd_tap_count: bool = False
) -> np.ndarray:
    """Nuttall windowed-sinc lowpass (``low_pass.h:7-12``)."""
    count = estimate_tap_count(trans_width, samplerate)
    if odd_tap_count and count % 2 == 0:
        count += 1
    return windowed_sinc(count, hz_to_rads(cutoff, samplerate))


def high_pass(
    cutoff: float, trans_width: float, samplerate: float, odd_tap_count: bool = False
) -> np.ndarray:
    """Highpass via Nyquist modulation of a lowpass (``high_pass.h:7-16``).

    The window is multiplied by (-1)^round(n), shifting the lowpass response
    of width (fs/2 - cutoff) up to Nyquist.
    """
    count = estimate_tap_count(trans_width, samplerate)
    if odd_tap_count and count % 2 == 0:
        count += 1
    coefs = COSINE_COEFS["nuttall"]

    def win(n, N):
        # C++ round() rounds half away from zero (np.round is half-to-even,
        # which would break the (-1)^n alternation on the x.5 grid).
        r = np.sign(n) * np.floor(np.abs(n) + 0.5)
        alt = np.where(r.astype(np.int64) % 2 != 0, -1.0, 1.0)
        return cosine_window(n, N, coefs) * alt

    return windowed_sinc(
        count, hz_to_rads(samplerate / 2.0 - cutoff, samplerate), window_fn=win
    )


def band_pass(
    band_start: float,
    band_stop: float,
    trans_width: float,
    samplerate: float,
    odd_tap_count: bool = False,
    complex_taps: bool = True,
) -> np.ndarray:
    """Bandpass by modulating a half-width lowpass (``band_pass.h:10-27``).

    Complex taps give the asymmetric (analytic, positive-frequency-only)
    bandpass used for e.g. the 19 kHz stereo pilot filter
    (``demod/broadcast_fm.h:43``); real taps give a symmetric bandpass.
    """
    assert band_stop > band_start
    offset_omega = hz_to_rads((band_start + band_stop) / 2.0, samplerate)
    count = estimate_tap_count(trans_width, samplerate)
    if odd_tap_count and count % 2 == 0:
        count += 1
    coefs = COSINE_COEFS["nuttall"]
    omega = hz_to_rads((band_stop - band_start) / 2.0, samplerate)

    if complex_taps:
        # Negative offset flips the taps: complex bandpass is asymmetric.
        def win_c(n, N):
            return np.exp(-1j * offset_omega * n) * cosine_window(n, N, coefs)

        i = np.arange(count, dtype=np.float64)
        half = count / 2.0
        t = i - half + 0.5
        corr = omega / np.pi
        taps = _sinc(t * omega) * win_c(t - half, count) * corr
        return taps.astype(np.complex64)

    def win_r(n, N):
        return 2.0 * np.cos(offset_omega * n) * cosine_window(n, N, coefs)

    return windowed_sinc(count, omega, window_fn=win_r)


def inverse_sinc(
    count: int, samplerate: float, f_max: float = 60000.0
) -> np.ndarray:
    """Linear-phase LS equalizer for the discriminator's sinc droop.

    A phase-difference FM discriminator at rate fs measures the AVERAGE
    instantaneous frequency over each 1/fs span, imposing a
    ``sinc(f/fs)`` magnitude droop on the demodulated MPX — inherent to
    any DDC-fed discriminator, including the reference's
    (``quadrature.h:39-46`` has it uncompensated; at 250 kHz IF it is
    -0.34 dB at the 38 kHz stereo subcarrier, capping stereo separation
    at ~34 dB, and -0.8 dB at the 57 kHz RDS subcarrier).  This designs
    a short symmetric FIR whose response approximates ``1/sinc(f/fs)``
    over [0, f_max] (weighted least squares; don't-care above), flattening
    the MPX to <0.03% with 11 taps.
    """
    assert count % 2 == 1
    M = (count - 1) // 2
    f = np.linspace(0.0, 0.48 * samplerate, 2000)
    target = 1.0 / np.sinc(f / samplerate)
    wgt = np.where(f <= f_max, 1.0, 0.05)
    k = np.arange(1, M + 1)
    # symmetric FIR: H(f) = h0 + 2*sum_k hk cos(2 pi f k / fs)
    A = np.concatenate(
        [np.ones((len(f), 1)), 2.0 * np.cos(2 * np.pi * np.outer(f / samplerate, k))],
        axis=1,
    )
    coef, *_ = np.linalg.lstsq(A * wgt[:, None], wgt * target, rcond=None)
    h = np.concatenate([coef[1:][::-1], coef[:1], coef[1:]])
    return h.astype(np.float32)


def root_raised_cosine(count: int, beta: float, Ts: float) -> np.ndarray:
    """Root-raised-cosine pulse taps (``root_raised_cosine.h:8-33``).

    ``Ts`` is the symbol period in samples (``samplerate / symbolrate``).
    """
    i = np.arange(count, dtype=np.float64)
    half = count / 2.0
    t = i - half + 0.5
    limit = Ts / (4.0 * beta)
    pi = np.pi

    center = (1.0 + beta * (4.0 / pi - 1.0)) / Ts
    at_limit = (
        (1.0 + 2.0 / pi) * np.sin(pi / (4.0 * beta))
        + (1.0 - 2.0 / pi) * np.cos(pi / (4.0 * beta))
    ) * beta / (Ts * np.sqrt(2.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        general = (
            np.sin((1.0 - beta) * pi * t / Ts)
            + np.cos((1.0 + beta) * pi * t / Ts) * 4.0 * beta * t / Ts
        ) / ((1.0 - (4.0 * beta * t / Ts) ** 2) * pi * t / Ts) / Ts
    taps = np.where(t == 0.0, center, general)
    taps = np.where(np.abs(np.abs(t) - limit) < 1e-12, at_limit, taps)
    return taps.astype(np.float32)


def root_raised_cosine_rate(
    count: int, beta: float, symbolrate: float, samplerate: float
) -> np.ndarray:
    return root_raised_cosine(count, beta, samplerate / symbolrate)


def raised_cosine(count: int, beta: float, Ts: float) -> np.ndarray:
    """Raised-cosine pulse taps (``raised_cosine.h:8-28``).

    NOTE: this reproduces the reference's formula EXACTLY, including its
    quirk — ``sinc(t/Ts) * pi/(4*Ts)`` everywhere except the |t| =
    Ts/(2*beta) singularity points, i.e. beta has no effect away from
    those points (the textbook raised cosine would multiply by
    ``cos(pi*beta*t/Ts) / (1 - (2*beta*t/Ts)^2)``).  The reference
    itself has no consumer of this function; use
    `root_raised_cosine` (which is the standard formula) for pulse
    shaping."""
    i = np.arange(count, dtype=np.float64)
    half = count / 2.0
    t = i - half + 0.5
    limit = Ts / (2.0 * beta)
    pi = np.pi
    at_limit = _sinc(np.array(1.0 / (2.0 * beta))) * pi / (4.0 * Ts)
    taps = _sinc(t / Ts) * pi / (4.0 * Ts)
    taps = np.where(np.abs(np.abs(t) - limit) < 1e-12, at_limit, taps)
    return taps.astype(np.float32)


def half_band(stage_samplerate: float = 1.0, att_taps: int = 0) -> np.ndarray:
    """Half-band lowpass for decimate-by-2 stages.

    Our own multistage-decimation design (the reference ships precomputed
    optimized plans, ``multirate/decim/plans.h``; we design ours fresh):
    cutoff at fs/4 with a generous transition so intermediate stages stay
    cheap — later stages and the final resampler clean up the band edge.
    """
    cutoff = 0.25 * stage_samplerate
    trans = 0.1 * stage_samplerate
    return low_pass(cutoff, trans, stage_samplerate)
