"""Plain reference of the multi-VFO WBFM receiver, in float64 PyTorch.

It computes from a configuration's rates and widths, and from the
wideband blocks the benchmark made, what each VFO's listener should hear
and what the waterfall should show, by the textbook route and not by
the program's:

1. each VFO mixed to baseband by its own oscillator, then the integer
   decimation to the IF rate as a cascade of decimating FIRs
   (`design.decimation_plan`; the program folds the same cascade into
   one frequency-domain overlap-save pass);
2. the FM discriminator ``angle(y[n] conj(y[n-1])) / (2 pi dev / fs)``;
3. stereo from the 19 kHz pilot's envelope: the real pilot bandpass
   ``r``, ``c2 = r^2 / mean_seg(r^2) - 1`` over 10 ms segments (the
   double-angle carrier ``cos 2 theta``), ``L - R = 2 g (delayed m) c2``
   with ``g`` the subcarrier droop gain, L and R delayed by the pilot
   filter's half length plus one;
4. the rational resampler to the audio rate, as the polyphase
   interpolator-decimator of SDR++'s ``multirate/rational_resampler.h``;
5. de-emphasis ``y[n] = a x[n] + (1-a) y[n-1]`` run to float64's
   precision;
6. the waterfall: each FFT interval's first ``min(interval, fft_size)``
   samples under the periodic Nuttall window, a centred transform and
   ``10 log10(|X|^2 / N^2 + 1e-20)``.

Every run starts from rest (zero filter memories, a previous
discriminator sample of 1), as the program's stream does.  Nothing here
imports the program.

``precision="tf32"`` is the control: the same arithmetic with every
operand of a product rounded to TF32 (10 mantissa bits), as TF32
contractions would take them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import design

PRECISIONS = ("f64", "tf32")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (round to nearest even on the 13 dropped
    mantissa bits of float32), returned as float64."""
    if x.is_complex():
        return torch.complex(tf32(x.real), tf32(x.imag))
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32).to(torch.float64)


class Arith:
    """Where the precision enters: the operands of every product."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.low = precision == "tf32"

    def op(self, x: torch.Tensor) -> torch.Tensor:
        return tf32(x) if self.low else x

    def corr(self, x: torch.Tensor, taps: np.ndarray,
             stride: int = 1) -> torch.Tensor:
        """Valid correlation along the last axis against the taps as
        stored (SDR++'s dot product over its history buffer):
        ``out[i] = sum_t taps[t] x[i*stride + t]``."""
        if x.is_complex():
            return torch.complex(self.corr(x.real, taps, stride),
                                 self.corr(x.imag, taps, stride))
        w = self.op(torch.as_tensor(np.ascontiguousarray(taps),
                                    dtype=torch.float64, device=x.device))
        lead = x.shape[:-1]
        rows = self.op(x).reshape(-1, 1, x.shape[-1])
        y = F.conv1d(rows, w.view(1, 1, -1), stride=stride)
        return y.reshape(lead + (y.shape[-1],))

    def fir(self, x: torch.Tensor, taps: np.ndarray,
            stride: int = 1) -> torch.Tensor:
        """FIR from rest, every ``stride``-th output:
        ``out[i] = sum_t taps[t] x[i*stride + t - (T-1)]``."""
        return self.corr(F.pad(x, (len(taps) - 1, 0)), taps, stride)


def vfo_offsets(cfg: dict) -> np.ndarray:
    fs = float(cfg["samplerate"])
    span = float(cfg["vfo_span"])
    return np.linspace(-span * fs, span * fs, int(cfg["vfos"]))


def channelize(ar: Arith, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """(n,) wideband -> (C, n / ratio) complex IF, each VFO at baseband."""
    fs, if_rate = float(cfg["samplerate"]), float(cfg["if_rate"])
    ratio = round(fs / if_rate)
    n = torch.arange(x.shape[-1], dtype=torch.float64, device=x.device)
    f = torch.as_tensor(vfo_offsets(cfg), dtype=torch.float64,
                        device=x.device)
    # the oscillator's phase, reduced exactly before the float64 angle
    cyc = torch.remainder(f[:, None] * n[None, :], fs) / fs
    lo = torch.polar(torch.ones_like(cyc), -2.0 * np.pi * cyc)
    y = ar.op(x.to(torch.complex128))[None, :] * ar.op(lo)
    for factor, taps in design.decimation_plan(fs, ratio,
                                               0.4 * if_rate):
        y = ar.fir(y, taps, factor)
    return y


def discriminate(cfg: dict, y: torch.Tensor) -> torch.Tensor:
    prev = torch.cat([torch.ones_like(y[..., :1]), y[..., :-1]], dim=-1)
    d = y * prev.conj()
    gain = 2.0 * np.pi * float(cfg["deviation"]) / float(cfg["if_rate"])
    return torch.atan2(d.imag, d.real) / gain


def stereo(ar: Arith, cfg: dict, m: torch.Tensor) -> torch.Tensor:
    """MPX (C, n) -> (2, C, n) left and right at the IF rate."""
    w, if_rate = cfg["wfm"], float(cfg["if_rate"])
    bp = design.band_pass_complex(w["pilot_lo_hz"], w["pilot_hi_hz"],
                                  w["pilot_trans_hz"], if_rate, odd=True)
    r = ar.fir(m, 2.0 * np.real(bp))
    r2 = r * r
    seg = round(float(w["envelope_segment_s"]) * if_rate)
    n = m.shape[-1]
    assert n % seg == 0, (n, seg)
    mean = r2.reshape(r2.shape[:-1] + (n // seg, seg)).mean(-1, keepdim=True)
    mean = mean.expand(r2.shape[:-1] + (n // seg, seg)).reshape(r2.shape)
    c2 = r2 / torch.clamp(mean, min=1e-12) - 1.0
    d = (len(bp) - 1) // 2 + 1
    lpr = F.pad(m, (d, 0))[..., :n]
    lmr = 2.0 * design.fm_subcarrier_comp(if_rate) * ar.op(lpr) * ar.op(c2)
    return torch.stack([lpr + lmr, lpr - lmr])


def resample(ar: Arith, cfg: dict, a: torch.Tensor) -> torch.Tensor:
    """(..., n) at the IF rate -> (..., n * L / M) at the audio rate."""
    if_rate, audio_rate = float(cfg["if_rate"]), float(cfg["audio_rate"])
    L, M = design.rational(if_rate, audio_rate)
    taps = design.low_pass(cfg["wfm"]["audio_bw_hz"],
                           cfg["wfm"]["audio_trans_hz"],
                           round(if_rate) * L) * L
    bank = design.polyphase_bank(L, taps)
    tpp = bank.shape[1]
    n = a.shape[-1]
    assert n % M == 0, (n, M)
    A = n // M
    ext = F.pad(a, (tpp - 1, 0))
    out = []
    for b in range(L):
        p, off = (b * M) % L, (b * M) // L
        seg = ext[..., off:off + (A - 1) * M + tpp]
        out.append(ar.corr(seg, bank[p], M))
    # out[b][..., a] is output a*L + b
    return torch.stack(out, dim=-1).reshape(a.shape[:-1] + (A * L,))


def deemphasize(ar: Arith, cfg: dict, a: torch.Tensor) -> torch.Tensor:
    """``y[n] = alpha x[n] + (1 - alpha) y[n-1]`` from rest; its impulse
    response is taken until it is below float64's resolution."""
    dt = 1.0 / float(cfg["audio_rate"])
    alpha = dt / (float(cfg["deemphasis_s"]) + dt)
    k = int(np.ceil(np.log(1e-18) / np.log(1.0 - alpha)))
    h = alpha * (1.0 - alpha) ** np.arange(k, dtype=np.float64)
    return ar.fir(a, h[::-1])


def waterfall(ar: Arith, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """(n,) wideband -> (frames, fft_size) dB."""
    fs, size = float(cfg["samplerate"]), int(cfg["fft_size"])
    interval = round(fs / float(cfg["fft_rate"]))
    nz = min(interval, size)
    assert size % 2 == 0 and x.shape[-1] % interval == 0
    seg = x.reshape(-1, interval)[:, :nz].to(torch.complex128)
    win = torch.as_tensor(design.spectrum_window(nz, size),
                          dtype=torch.float64, device=x.device)
    spec = torch.fft.fft(ar.op(seg) * ar.op(win), n=size, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    return 10.0 * torch.log10(power / float(size) ** 2 + 1e-20)


def run(cfg: dict, blocks: torch.Tensor, precision: str = "f64") -> dict:
    """``blocks`` (k, block_len) complex, consecutive, from rest ->
    ``{"audio": (k, 2, C, n_af), "spec": (k, frames, fft_size)}``,
    float64, on ``blocks``' device."""
    ar = Arith(precision)
    k, n = blocks.shape
    x = blocks.reshape(-1)
    m = discriminate(cfg, channelize(ar, cfg, x))
    a = deemphasize(ar, cfg, resample(ar, cfg, stereo(ar, cfg, m)))
    audio = a.reshape(2, a.shape[1], k, -1).movedim(2, 0)
    spec = waterfall(ar, cfg, x)
    return {"audio": audio, "spec": spec.reshape(k, -1, spec.shape[-1])}


def gaps(cfg: dict, got: dict, want: dict) -> dict:
    """The numbers compared, over the blocks given (``got`` the program's
    float32 outputs, ``want`` the reference's):

    - ``audio_gap``: the largest absolute difference of any audio sample
      (full scale is 1; the stations' audio peaks near 0.9);
    - ``waterfall_gap_db``: the largest difference in dB of any waterfall
      bin within 80 dB of its frame's peak (the noise floor lies some
      50 dB under the stations' bins, so it is inside)."""
    dev = want["audio"].device
    audio = (got["audio"].to(dev, torch.float64) - want["audio"]).abs().max()
    ref = want["spec"]
    live = ref > ref.amax(dim=-1, keepdim=True) - 80.0
    spec = (got["spec"].to(dev, torch.float64) - ref).abs()[live].max()
    return {"audio_gap": float(audio), "waterfall_gap_db": float(spec)}
