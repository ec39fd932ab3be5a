"""Window functions (design-time, NumPy float64).

Generalized cosine-sum windows matching the reference's centered
formulation (``core/src/dsp/window/cosine.h:8-18``): the window argument
``n`` is a *centered* sample index and coefficients alternate in sign,

    w(n) = sum_i (-1)^i c_i cos(2 pi i n / N)

which is identical to the textbook form evaluated at ``n + N/2``.  These are
used for FIR tap design (`taps.py`) and FFT spectrum windowing
(`fftspec.py`); they run at (re)configuration time on the host, so they are
plain NumPy in float64.
"""

from __future__ import annotations

import numpy as np

# Coefficients per reference core/src/dsp/window/{rectangular,hann,hamming,
# blackman,nuttall,blackman_harris,blackman_nuttall}.h (standard published
# cosine-sum window families).
COSINE_COEFS: dict[str, tuple[float, ...]] = {
    "rectangular": (1.0,),
    "hann": (0.5, 0.5),
    "hamming": (0.54, 0.46),
    "blackman": (0.42, 0.5, 0.08),
    "blackman_harris": (0.35875, 0.48829, 0.14128, 0.01168),
    "blackman_nuttall": (0.3635819, 0.4891775, 0.1365995, 0.0106411),
    "nuttall": (0.355768, 0.487396, 0.144232, 0.012604),
}


def cosine_window(n, N: float, coefs) -> np.ndarray:
    """Centered cosine-sum window, vectorized over ``n``.

    ``n`` may span ``[-N, 0]`` or ``[-N/2, N/2]``; the function is even, with
    maximum (== sum of coefs) at ``|n| = N/2`` per the reference convention
    where callers pass ``n`` offset by half the tap count.
    """
    n = np.asarray(n, dtype=np.float64)
    w = np.zeros_like(n)
    sign = 1.0
    for i, c in enumerate(coefs):
        w += sign * c * np.cos(i * 2.0 * np.pi * n / N)
        sign = -sign
    return w


def get_window(name: str, n, N: float) -> np.ndarray:
    """Evaluate a named window at (centered) indices ``n`` for length ``N``."""
    return cosine_window(n, N, COSINE_COEFS[name])


def periodic_window(name: str, count: int) -> np.ndarray:
    """Window sampled at integer points for FFT use.

    The centered cosine form is zero at ``n = 0`` and peaks at
    ``|n| = N/2``, so a buffer-spanning window evaluates ``n`` over
    ``[-N, 0)`` (the same convention ``windowed_sinc`` uses via its
    ``t - half`` argument).
    """
    i = np.arange(count, dtype=np.float64)
    return get_window(name, i - float(count), count)
