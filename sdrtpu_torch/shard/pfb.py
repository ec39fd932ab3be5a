"""Oversampled polyphase filter-bank (PFB) channelizer (PyTorch counterpart
of ``sdrtpu/shard/pfb.py``).

One shared M-bin analysis filter bank over the wideband input, then
per-channel work only at the decimated bin rate:

    ext = [tail ++ x]                                (streaming history)
    z_t[r]  = sum_q h[qM + r] * ext[tD + qM + r]     (polyphase fold)
    Y_t     = FFT_M(z_t) * twiddle[t mod V]          (all M bins at once)
    y_c     = Y[:, bin_c]                            (per-channel gather)
              -> residual rotator (delta_c = f_c - bin_c*fs/M, at fb)
              -> rational resample fb -> if_rate

with D the hop (bin rate fb = fs/D), V = M/D the oversample factor, and
h an M*tpp-tap lowpass prototype.  The plan, the prototype and the
twiddles are the reference's host numpy, so the tables are identical.

The fold reads ``ext`` through one strided view ``W[t, q, r] = ext[tD +
qM + r]`` (no copy, on the float32 pairs of the samples) and sums the
``tpp`` weighted rows in ascending q: the order of the reference's loop,
so each output rounds as it does, in 2*tpp - 1 elementwise launches per
call (the reference's loop over the V column groups is folded into the
view).

Retuning swaps the int32 bin indices and the residual rotator's tables
(`MultiVfoMixer` state) in the state and keeps every history, as the
reference.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp
from ..kernels import taps as tapsmod
from ..kernels.resample import RationalResampler
from .channelizer import MultiVfoMixer


def plan_pfb(fs: float, if_rate: float, att_taps_factor: float = 4.0):
    """Pick (M, D, tpp) for an oversampled analysis bank (the reference's
    planner): D | M, a bin rate fs/D rational to ``if_rate`` with small
    polyphase factors, a positive transition band; the plan with the
    least modelled shared work per input sample."""
    best = None
    for M in (16, 32, 64, 128, 256, 512, 1024):
        for V in (2, 4, 8, 16):
            if M % V:
                continue
            D = M // V
            fb = fs / D
            frac = Fraction(fb / if_rate).limit_denominator(1 << 12)
            if abs(float(frac) - fb / if_rate) > 1e-9 or frac.numerator > 512:
                continue
            p_pass = 0.5 * if_rate + fs / (2.0 * M)
            trans = fb / 2.0 - p_pass
            if trans <= if_rate * 0.05:
                continue
            ntaps = att_taps_factor * fs / trans
            tpp = max(4, int(np.ceil(ntaps / M)))
            cost = 2.0 * tpp * V + 5.0 * np.log2(M) * V
            if best is None or cost < best[0]:
                best = (cost, M, D, tpp)
    if best is None:
        raise ValueError(f"no PFB plan for fs={fs}, if_rate={if_rate}")
    return best[1], best[2], best[3]


class PfbChannelizer(StreamOp):
    """C VFOs at arbitrary offsets via a shared M-bin filter bank.

    Takes any whole number of blocks per call (the rotator's closed-form
    K-block pass), like `FftDecimatorChain`.
    """

    def __init__(self, offsets_hz, in_samplerate: float, if_rate: float,
                 block_len: int, bins: int | None = None,
                 decim: int | None = None, tpp: int | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        fs = float(in_samplerate)
        self.fs = fs
        self.if_rate = float(if_rate)
        offsets = np.asarray(offsets_hz, np.float64)
        self.offsets = offsets
        self.n_channels = len(offsets)
        if bins is None or decim is None or tpp is None:
            bins, decim, tpp = plan_pfb(fs, if_rate)
        M, D = int(bins), int(decim)
        assert M % D == 0, (M, D)
        self.M, self.D, self.V, self.tpp = M, D, M // D, tpp
        self.fb = fs / D
        self.block_len = int(block_len)
        # whole frames per block, and a multiple of the twiddle period V
        # (block % M == 0), so per-block frame indices stay congruent
        # with the global stream
        assert self.block_len % M == 0, (self.block_len, M)
        L = M * tpp
        self.L = L

        # prototype lowpass at the input rate; its passband covers the
        # channel band shifted by the worst-case nearest-bin residual;
        # unit passband gain (taps sum to 1)
        p_pass = 0.5 * self.if_rate + fs / (2.0 * M)
        trans = self.fb / 2.0 - p_pass
        h = tapsmod.low_pass(p_pass, trans, fs, odd_tap_count=False)
        hp = np.zeros(L, np.float64)
        hp[: min(len(h), L)] = h[:L] / np.sum(h[:L])
        self._h2 = np.ascontiguousarray(hp.reshape(tpp, M)).astype(
            np.float32)  # h2[q, r] = h[q*M + r]
        # frame twiddle e^{-2pi i m t D / M}, period V in t
        m = np.arange(M)
        v = np.arange(self.V)[:, None]
        self._tw = np.exp(-2j * np.pi * m[None, :] * v * D / M).astype(
            np.complex64)
        # each tap twice, for the real and imaginary parts of a sample
        self._h2_pairs = torch.as_tensor(np.repeat(self._h2, 2, axis=1),
                                         device=self.device)
        self._tw_dev = torch.as_tensor(self._tw, device=self.device)

        self._assign(offsets)
        F = self.block_len // self.D
        self.resamp = RationalResampler(self.fb, self.if_rate,
                                        device=self.device)
        assert F % self.resamp.block_multiple() == 0, (
            f"block {block_len}: {F} PFB frames not a multiple of the "
            f"fb->if resampler quantum {self.resamp.block_multiple()}")

    def _assign(self, offsets):
        """Nearest bin + residual for each channel."""
        M, fs = self.M, self.fs
        bins = np.round(offsets * M / fs).astype(np.int64)
        delta = offsets - bins * fs / M  # |delta| <= fs/(2M)
        self._bins = np.mod(bins, M).astype(np.int32)
        self._delta = delta
        # the mixer brings +delta down to baseband at the bin rate
        self.rot = MultiVfoMixer([-d for d in delta], self.fb,
                                 self.block_len // self.D, device=self.device)

    @staticmethod
    def block_multiple_for(fs, if_rate) -> int:
        M, D, _ = plan_pfb(fs, if_rate)
        r = RationalResampler(fs / D, if_rate, device="cpu")
        a, b = M, D * r.block_multiple()
        return a * b // int(np.gcd(a, b))

    def init_state(self):
        return {
            "tail": torch.zeros(self.L - self.D, dtype=torch.complex64,
                                device=self.device),
            "bins": torch.as_tensor(self._bins.copy(), device=self.device),
            "rot": self.rot.init_state(),
            "resamp": self.resamp.init_state(),
        }

    def retune_state(self, state, offsets_hz) -> dict:
        """Swap bin indices + residual-rotator tables; keep histories and
        each channel's rotator phase."""
        offsets = np.asarray(offsets_hz, np.float64)
        assert offsets.shape == self.offsets.shape
        old_phase = state["rot"]["phase"]
        self._assign(offsets)
        self.offsets = offsets
        new_rot = self.rot.init_state()
        new_rot["phase"] = old_phase
        return {
            "tail": state["tail"],
            "bins": torch.as_tensor(self._bins.copy(), device=self.device),
            "rot": new_rot,
            "resamp": state["resamp"],
        }

    def out_len(self, n: int) -> int:
        return self.resamp.out_len(n // self.D)

    def fold(self, ext: torch.Tensor, F: int) -> torch.Tensor:
        """The polyphase fold of ``F`` frames: ``(F, M)`` complex64.

        ``ext`` (contiguous) holds the L - D carried samples then F*D new
        ones.  It runs on the float32 pairs of the complex samples: a
        complex sample times a real tap rounds each part as the real
        products do, so the bits are the complex form's."""
        M, D = self.M, self.D
        W = torch.view_as_real(ext).as_strided((F, self.tpp, 2 * M),
                                               (2 * D, 2 * M, 1))
        h2 = self._h2_pairs
        z = W[:, 0, :] * h2[0]
        for q in range(1, self.tpp):
            z = z + W[:, q, :] * h2[q]
        return torch.view_as_complex(z.view(F, M, 2))

    def __call__(self, state, x):
        n = x.shape[-1]
        assert n % self.block_len == 0, (n, self.block_len)
        K = n // self.block_len
        M, V = self.M, self.V
        ext = torch.cat([state["tail"], x.to(torch.complex64)])
        new_tail = ext[n:]
        F = n // self.D
        z = self.fold(ext, F)
        Y = torch.fft.fft(z)  # (F, M)
        # frame twiddle (period V); F % V == 0 by the block quantum
        Y = (Y.reshape(F // V, V, M) * self._tw_dev).reshape(F, M)
        # per-channel bin gather -> (C, F) at the bin rate
        y = Y.index_select(1, state["bins"].to(torch.int64)).T
        if K == 1:
            st_rot, y = self.rot(state["rot"], y)
        else:
            st_rot, y = self.rot.rotate_blocks(state["rot"], y, K)
        st_rs, y = self.resamp(state["resamp"], y)
        return {"tail": new_tail, "bins": state["bins"], "rot": st_rot,
                "resamp": st_rs}, y
