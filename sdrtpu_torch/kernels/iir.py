"""First-order IIR recurrences (PyTorch counterpart of ``sdrtpu/kernels/iir.py``).

`first_order_recurrence` solves ``y[n] = a[n]*y[n-1] + b[n]`` across a
whole block in ``log2(n)`` doubling passes; `DcBlocker` and the long-pole
branch of `Deemphasis` run on it.

At audio rates the de-emphasis lowpass ``y[n] = alpha*x[n] +
(1-alpha)*y[n-1]`` has an impulse response that underflows float32 within
a few dozen samples, so it runs as a truncated-impulse FIR plus the
``a^(n+1) * y0`` carry term; poles with a longer memory take the
recurrence.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp
from .fir import correlate_valid, matmul_correlate_valid, toeplitz_matrix


def first_order_recurrence(a, b: torch.Tensor, y0) -> torch.Tensor:
    """Solve ``y[n] = a[n]*y[n-1] + b[n]`` (``y[-1] = y0``) along the last
    axis; ``a`` is a Python scalar or a real tensor of ``b``'s shape.

    Each sample is the affine map ``y -> A*y + B``; composing (A1, B1)
    then (A2, B2) gives (A1*A2, A2*B1 + B2).  Pass ``k`` composes every
    sample with the map ``2^k`` to its left, so after ``ceil(log2 n)``
    passes sample ``i`` holds the composition of samples ``0..i``.  All
    terms stay bounded for ``|a| <= 1`` (no ``a^-k`` factor appears), and
    each output is a sum of log depth, so float32 does not drift over
    long blocks.  For a scalar ``a`` the composed ``A`` is a known power,
    taken in float64 on the host (`_powers`).
    """
    n = b.shape[-1]
    B = b.clone()
    if isinstance(a, torch.Tensor):
        A = a.to(B.real.dtype).expand(b.shape).clone()
        off = 1
        while off < n:
            # right-hand sides are evaluated whole before the store, so
            # the shifted in-place update reads only old values
            B[..., off:] = B[..., :-off] * A[..., off:] + B[..., off:]
            A[..., off:] = A[..., :-off] * A[..., off:]
            off *= 2
    else:
        a = float(a)
        off = 1
        while off < n:
            a_off = float(np.float32(a ** off))
            if a_off == 0.0:
                break
            B[..., off:] = B[..., :-off] * a_off + B[..., off:]
            off *= 2
        A = _powers(a, n, b.device)
    return A * y0 + B


@functools.cache
def _powers(a: float, n: int, device) -> torch.Tensor:
    """``a^(k+1)``, k < n, in float64 on the host, rounded to float32
    and moved to ``device`` once per ``(a, n, device)``: a host copy on
    every call would wait for the device's queue, and cannot be captured
    in a CUDA graph.  Kept for the process, so a captured graph's read
    of it stays valid."""
    return torch.as_tensor(
        (a ** (np.arange(n, dtype=np.float64) + 1.0)).astype(np.float32),
        device=device)


class Deemphasis(StreamOp):
    """FM de-emphasis, ``alpha = dt / (tau + dt)``, on real (..., n) blocks.

    Branch choice as in the reference: the banded-Toeplitz matmul from
    ``mm_min_elements`` total elements, the shift-and-add below it (the
    two differ at rounding level, so the port must pick the same one).
    """

    _FIR_EPS = 1e-9
    _FIR_MAX_TAPS = 256

    def __init__(self, tau: float, samplerate: float, channels: int = 1,
                 mm_min_elements: int = 1 << 15, device="cuda"):
        self.device = resolve_device(device)
        dt = 1.0 / float(samplerate)
        self.alpha = np.float32(dt / (float(tau) + dt))
        self.channels = channels
        self.mm_min_elements = int(mm_min_elements)
        a = 1.0 - float(self.alpha)
        T = int(np.ceil(np.log(self._FIR_EPS) / np.log(a))) if a > 0 else 1
        self._a = 1.0 - np.float64(self.alpha)
        if T > self._FIR_MAX_TAPS:
            self._fir = None  # long memory: `first_order_recurrence`
            return
        k = np.arange(T, dtype=np.float64)
        # correlate_valid orientation: h[t] = alpha * a^(T-1-t)
        self._fir = (float(self.alpha) * a ** (T - 1 - k)).astype(np.float32)
        self._ntaps = T
        self._H = torch.as_tensor(toeplitz_matrix(self._fir, 128),
                                  device=self.device)
        self._decays = {}  # (n, device) -> the carry term's factors

    def init_state(self):
        shape = () if self.channels == 1 else (self.channels, 1)
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def __call__(self, state, x):
        if self._fir is None:
            a = np.float32(1.0) - self.alpha
            y = first_order_recurrence(float(a), float(self.alpha) * x, state)
            return y[..., -1:], y
        T = self._ntaps
        n = x.shape[-1]
        xpad = torch.cat([x.new_zeros(x.shape[:-1] + (T - 1,)), x], dim=-1)
        if x.numel() >= self.mm_min_elements:
            y = matmul_correlate_valid(xpad, self._fir, H=self._H)
        else:
            y = correlate_valid(xpad, self._fir)
        y = y + self._decay(n, x.device) * state
        return y[..., -1:], y

    def _decay(self, n: int, device) -> torch.Tensor:
        """The carry term's factors a^(k+1), k < n (nonzero only in the
        first T), built in float64 on the host and moved to ``device``
        once per ``n``: a host copy on every call would wait for the
        device's queue, and cannot be captured in a CUDA graph."""
        key = (n, device)
        decay = self._decays.get(key)
        if decay is None:
            host = np.zeros(n, np.float32)
            m = min(self._ntaps, n)
            host[:m] = (self._a ** (np.arange(m, dtype=np.float64) + 1.0)
                        ).astype(np.float32)
            decay = self._decays[key] = torch.as_tensor(host, device=device)
        return decay


class DcBlocker(StreamOp):
    """DC tracking subtractor: ``offset[n] = (1-rate)*offset[n-1] +
    rate*x[n]``, ``out[n] = x[n] - offset[n-1]``.  State: the offset."""

    def __init__(self, rate: float, dtype=torch.complex64, device="cuda"):
        self.device = resolve_device(device)
        self.rate = np.float32(rate)
        self.dtype = dtype

    def init_state(self):
        return torch.zeros((), dtype=self.dtype, device=self.device)

    def __call__(self, state, x):
        a = np.float32(1.0) - self.rate
        offsets = first_order_recurrence(float(a), float(self.rate) * x, state)
        prev = torch.cat([state.expand(offsets[..., :1].shape),
                          offsets[..., :-1]], dim=-1)
        new_state = offsets[..., -1] if offsets.ndim == 1 else offsets[..., -1:]
        return new_state, x - prev
