"""Multirate resampling (PyTorch counterpart of ``sdrtpu/kernels/resample.py``).

- `IntegerDecimator`: decimation by any integer as a cascade of strided
  FIR stages designed on the fly (`design_decimation_stages`).
- `PolyphaseResampler`: L/M polyphase interpolator-decimator with the
  reference's phase/offset math, as the reference's ``"matmul"`` method
  (the WFM audio path): shifted row views against a host-built window
  matrix; it takes the reference's ``method`` names and computes each
  with the matmul.
- `RationalResampler`: the reference's planner — it must emit the same
  plan and the same taps, because the channelizer takes its channel
  filter from it.

Host-side design math (taps, banks, window matrices) is float64 numpy as
in the reference; the matrices are moved to the device once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp
from . import taps as tapsmod
from .fir import DecimatingFir, _pad_last, shifted_window_matmul


def build_polyphase_bank(interp: int, taps: np.ndarray) -> np.ndarray:
    """Split prototype taps into ``interp`` phases: (interp, tpp) float32
    with ``bank[p, t] = taps[t*interp + (interp-1-p)]`` (zero-padded)."""
    interp = int(interp)
    tpp = -(-len(taps) // interp)
    padded = np.zeros(interp * tpp, dtype=np.float64)
    padded[: len(taps)] = np.asarray(taps, np.float64)
    bank = np.zeros((interp, tpp), dtype=np.float64)
    for i in range(interp * tpp):
        bank[(interp - 1) - (i % interp), i // interp] = padded[i]
    return bank.astype(np.float32)


def design_decimation_stages(
    in_rate: float, ratio: int, out_bw: float | None = None
) -> list[tuple[int, np.ndarray]]:
    """Factor an integer decimation into stages with per-stage filters:
    [(decim_i, taps_i), ...], largest factors first; each stage passes
    ``out_bw`` (default 40% of the final rate) and stops at the next
    stage's folding edge."""
    assert ratio >= 1
    final_rate = in_rate / ratio
    if out_bw is None:
        out_bw = 0.4 * final_rate
    factors: list[int] = []
    d = ratio
    for p in (8, 7, 6, 5, 4, 3, 2):
        while d % p == 0 and d > 1:
            factors.append(p)
            d //= p
    if d > 1:
        factors.append(d)
    factors.sort(reverse=True)

    stages = []
    r = in_rate
    for di in factors:
        r_next = r / di
        stop = r_next - out_bw
        trans = max(stop - out_bw, 0.05 * r_next)
        cutoff = min((out_bw + stop) / 2.0, 0.45 * r_next)
        stages.append((di, tapsmod.low_pass(cutoff, trans, r)))
        r = r_next
    return stages


class IntegerDecimator(StreamOp):
    """Decimate by an arbitrary integer ratio (multistage strided FIRs)."""

    def __init__(self, in_rate: float, ratio: int, dtype=torch.complex64,
                 out_bw: float | None = None, device="cuda"):
        self.ratio = int(ratio)
        self.dtype = dtype
        self.stages = [
            DecimatingFir(taps, d, dtype, device=device)
            for d, taps in design_decimation_stages(in_rate, ratio, out_bw)
        ]

    def init_state(self):
        return tuple(s.init_state() for s in self.stages)

    def out_len(self, n: int) -> int:
        assert n % self.ratio == 0
        return n // self.ratio

    def __call__(self, state, x):
        new_states = []
        for s, st in zip(self.stages, state):
            st, x = s(st, x)
            new_states.append(st)
        return tuple(new_states), x


class PolyphaseResampler(StreamOp):
    """L/M polyphase resampler, block-parallel.

    Output k uses phase ``(k*decim) % interp`` and window start
    ``(k*decim) // interp`` into [tail ++ x]; outputs group into
    ``(A, interp)`` and

        out[a, b] = sum_t bank[p_b, t] * ext[a*decim + off_b + t],

    evaluated as the frame matrix ``F[a, j] = ext[a*decim + j]`` times the
    window matrix ``G[j, b] = bank[p_b, t]`` at ``j = off_b + t``: R
    matmuls on shifted views of one (rows, decim) reshape
    (`shifted_window_matmul`).  This is the reference's ``"matmul"``
    method.  ``method`` takes the reference's names, "auto", "matmul",
    "unrolled" and "gather"; every form computes the same sums, and the
    port computes them all with the matmul (in float32, so the sums'
    order, and the last bits, differ from the reference's shift-and-add
    forms).
    """

    def __init__(self, interp: int, decim: int, taps: np.ndarray,
                 dtype=torch.complex64, method: str = "auto", device="cuda"):
        self.device = resolve_device(device)
        self.interp = int(interp)
        self.decim = int(decim)
        self.dtype = dtype
        bank = build_polyphase_bank(self.interp, taps)
        self.taps_per_phase = bank.shape[1]
        self.bank = bank
        if method not in ("auto", "unrolled", "gather", "matmul"):
            raise ValueError(f"unknown PolyphaseResampler method {method!r}")
        self.method = "matmul"  # the form computed, whatever was asked
        L, M, tpp = self.interp, self.decim, self.taps_per_phase
        R = 1 + -(-(tpp - 1) // M) if tpp > 1 else 1
        G = np.zeros((R * M, L), np.float64)
        for b in range(L):
            p_b = (b * M) % L
            off_b = (b * M) // L
            G[off_b : off_b + tpp, b] = bank[p_b]
        self._G = torch.as_tensor(G.astype(np.float32), device=self.device)
        self._R = R

    def init_state(self):
        return torch.zeros((self.taps_per_phase - 1,), dtype=self.dtype,
                           device=self.device)

    def out_len(self, n: int) -> int:
        assert n % self.decim == 0, (
            f"block length {n} must be a multiple of decim={self.decim}"
        )
        return (n * self.interp) // self.decim

    def __call__(self, state, x):
        n = x.shape[-1]
        n_out = self.out_len(n)
        M, tpp = self.decim, self.taps_per_phase
        lead = x.shape[:-1]
        ext = torch.cat([state.expand(lead + (tpp - 1,)), x.to(self.dtype)],
                        dim=-1)
        A = n_out // self.interp
        rows = A + self._R - 1
        xr = _pad_last(ext, rows * M - ext.shape[-1]).reshape(lead + (rows, M))
        if ext.is_complex():
            out = shifted_window_matmul(torch.stack((xr.real, xr.imag)),
                                        self._G, A)
            y = torch.complex(out[0], out[1])
        else:
            y = shifted_window_matmul(xr, self._G, A)
        return ext[..., n:], y.reshape(lead + (n_out,))


class RationalResampler(StreamOp):
    """Arbitrary rate conversion with automatic staging.

    Planner (as the reference): a single-stage gcd-reduced polyphase
    when its frame matrix stays narrow (``decim + tpp <=
    SINGLE_STAGE_MAX_W``), else the largest integral pre-decimation
    ``d`` (`IntegerDecimator`) followed by the reduced polyphase.
    Prototype: Nuttall lowpass at ``bw`` (default min(in, out)/2) with
    ``trans_bw`` (default 10% of it), scaled by interp.
    """

    SINGLE_STAGE_MAX_W = 2048

    def __init__(self, in_samplerate: float, out_samplerate: float,
                 dtype=torch.complex64, bw: float | None = None,
                 trans_bw: float | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.in_samplerate = float(in_samplerate)
        self.out_samplerate = float(out_samplerate)
        self.dtype = dtype
        int_sr = round(in_samplerate)
        out_sr = round(out_samplerate)

        d = int_sr // out_sr
        while d > 1 and int_sr % d != 0:
            d -= 1

        plan_taps = None
        if d > 1 and int_sr != out_sr:
            g1 = math.gcd(int_sr, out_sr)
            L1, M1 = out_sr // g1, int_sr // g1
            if L1 > 1:
                bw1 = (bw if bw is not None
                       else min(in_samplerate, out_samplerate) / 2.0)
                taps1 = tapsmod.low_pass(bw1, trans_bw or bw1 * 0.1,
                                         int_sr * L1)
                tpp1 = -(-len(taps1) // L1)
                if M1 + tpp1 <= self.SINGLE_STAGE_MAX_W:
                    d = 1
                    plan_taps = taps1
        mid_sr = int_sr // d if d > 1 else int_sr

        g = math.gcd(mid_sr, out_sr)
        interp = out_sr // g
        decim = mid_sr // g
        actual_out = mid_sr * interp / decim
        self.rate_error_pct = (
            abs((actual_out - out_samplerate) / out_samplerate) * 100.0
        )
        self.predecim = (
            IntegerDecimator(
                in_samplerate, d, dtype,
                out_bw=bw if bw is not None else 0.4 * out_samplerate,
                device=self.device,
            )
            if d > 1 else None
        )
        self.interp = interp
        self.decim = decim
        if interp != decim:
            if plan_taps is not None:
                rtaps = plan_taps * np.float32(interp)
            else:
                tap_sr = mid_sr * interp
                pbw = (bw if bw is not None
                       else min(in_samplerate, out_samplerate) / 2.0)
                rtaps = tapsmod.low_pass(pbw, trans_bw or pbw * 0.1,
                                         tap_sr) * np.float32(interp)
            self.resamp = PolyphaseResampler(interp, decim, rtaps, dtype,
                                             device=self.device)
        else:
            self.resamp = None

    def init_state(self):
        return (
            self.predecim.init_state() if self.predecim else (),
            self.resamp.init_state() if self.resamp else (),
        )

    def out_len(self, n: int) -> int:
        if self.predecim:
            n = self.predecim.out_len(n)
        if self.resamp:
            n = self.resamp.out_len(n)
        return n

    def block_multiple(self) -> int:
        """Smallest input block length quantum keeping all shapes static."""
        m = self.predecim.ratio if self.predecim else 1
        if self.resamp:
            m *= self.resamp.decim
        return m

    def __call__(self, state, x):
        st_d, st_r = state
        if self.predecim:
            st_d, x = self.predecim(st_d, x)
        if self.resamp:
            st_r, x = self.resamp(st_r, x)
        return (st_d, st_r), x
