"""FFT spectrum / waterfall (PyTorch counterpart of ``sdrtpu/kernels/fftspec.py``).

Framing as ``IQFrontEnd::genReshapeParams``: per FFT interval
``round(fs/fft_rate)`` input samples, of which ``nz = min(interval,
fft_size)`` are windowed (zero-padded to ``fft_size``) and the rest
skipped.  For even sizes the (-1)^i centering is folded into the window
(equal to an fftshift of the spectrum); odd sizes shift explicitly.
dB: ``10*log10(|X|^2 / fft_size^2 + 1e-20)``.

The reference splits long transforms into a four-step FFT to dodge a
slow TPU shape; here one ``torch.fft.fft`` (cuFFT) computes the same
transform, and `four_step_fft` is kept as the reference's numerical
counterpart only: nothing on the main path calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp
from ..metrics import span
from .windows import periodic_window


def gen_reshape_params(samplerate: float, fft_size: int, fft_rate: float):
    """(skip, nz_samp_count) per ``IQFrontEnd::genReshapeParams``."""
    fft_interval = round(samplerate / fft_rate)
    nz = min(fft_interval, fft_size)
    return fft_interval - nz, nz


def four_step_fft(x: torch.Tensor, n1: int | None = None) -> torch.Tensor:
    """Length-N FFT of the last axis as two batched small FFTs.

    Four-step Cooley-Tukey with N = N1*N2, n = n1*N2 + n2, k = k2*N1 + k1:

        A[n2, k1] = FFT_N1(x[n1, n2] over n1)
        B[k1, k2] = FFT_N2(A[n2, k1] * W^(k1*n2) over n2)
        X[k2*N1 + k1] = B[k1, k2]

    The reference's split (a small first factor, N1 = 2^(floor(log2 N)/2
    - 2), halved until it divides N) and its float64 host twiddles in
    complex64.  Its reason, a slow single long FFT row on the TPU, does
    not hold for cuFFT: this is a numerical counterpart, not a speed
    path.
    """
    N = int(x.shape[-1])
    if n1 is None:
        n1 = 1 << max(0, int(np.log2(max(N, 2))) // 2 - 2)
        while n1 > 1 and N % n1:  # N need not be a power of two
            n1 >>= 1
    n2 = N // n1
    assert n1 * n2 == N, (N, n1)
    lead = x.shape[:-1]
    x2 = x.to(torch.complex64).reshape(lead + (n1, n2))
    a = torch.fft.fft(x2.transpose(-1, -2))  # (..., n2, n1) = A[n2, k1]
    k1 = np.arange(n1)[None, :]
    nn2 = np.arange(n2)[:, None]
    w = np.exp(-2j * np.pi * (k1 * nn2) / N).astype(np.complex64)
    b = torch.fft.fft((a * torch.as_tensor(w, device=x.device))
                      .transpose(-1, -2))  # B[k1, k2]
    return b.transpose(-1, -2).reshape(lead + (N,))


class SpectrumAnalyzer(StreamOp):
    """Block of IQ -> (frames, fft_size) centered dB spectra.

    Block lengths must be a multiple of the FFT interval (keep + skip).
    """

    def __init__(self, samplerate: float, fft_size: int = 65536,
                 fft_rate: float = 20.0, window: str = "nuttall",
                 device="cuda"):
        self.device = resolve_device(device)
        self.samplerate = float(samplerate)
        self.fft_size = int(fft_size)
        self.fft_rate = float(fft_rate)
        skip, nz = gen_reshape_params(samplerate, fft_size, fft_rate)
        self.skip = skip
        self.nz_size = nz
        self.interval = skip + nz
        w = periodic_window(window, nz).astype(np.float64)
        self._center_in_window = self.fft_size % 2 == 0
        if self._center_in_window:
            w *= (-1.0) ** np.arange(nz)
        self.window = w.astype(np.float32)
        self._window_t = torch.as_tensor(self.window, device=self.device)

    def init_state(self):
        return ()

    def out_len(self, n: int) -> int:
        assert n % self.interval == 0, (
            f"block length {n} must be a multiple of FFT interval {self.interval}"
        )
        return n // self.interval

    def extract(self, x: torch.Tensor) -> torch.Tensor:
        """Keep/skip framing only: block -> (frames, nz_size) raw segments."""
        n = x.shape[-1]
        return x.reshape(n // self.interval, self.interval)[:, : self.nz_size]

    def transform(self, segments: torch.Tensor) -> torch.Tensor:
        """(frames, nz_size) raw segments -> (frames, fft_size) dB, in the
        span ``sdrtpu.waterfall``."""
        with span("sdrtpu.waterfall"):
            frames = segments * self._window_t
            spec = torch.fft.fft(frames, n=self.fft_size, dim=-1)
            if not self._center_in_window:
                spec = torch.fft.fftshift(spec, dim=-1)
            power = spec.real ** 2 + spec.imag ** 2
            db = 10.0 * torch.log10(
                power / np.float32(self.fft_size ** 2) + 1e-20)
            return db.to(torch.float32)

    def __call__(self, state, x):
        return state, self.transform(self.extract(x))
