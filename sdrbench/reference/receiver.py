"""Plain reference of the mixed-mode receiver (``rx8_mixed_10msps``), in
float64 PyTorch.

From a configuration's VFOs, modes and rates, and from the wideband
blocks the benchmark made, it computes what each VFO's listener should
hear and what the waterfall should show, by the textbook route and not
by the program's:

1. each VFO mixed to baseband by its own float64 oscillator;
2. the decimation to the mode's IF rate as direct decimating FIRs: the
   integer part a cascade (`design.decimation_plan`), then, where the
   rates are not in an integer ratio, a polyphase interpolator-decimator
   (SDR++'s ``multirate/rational_resampler.h``).  The plan and the taps
   follow the program's documented design rule (`rational_plan`): the
   largest integer pre-decimation that divides the input rate, unless a
   single polyphase stage stays narrow; each stage passing 40 % of the
   output rate;
3. the demodulator, after SDR++'s radio module:

   - WFM: the discriminator at deviation bw/2, the MPX equaliser
     (`inverse_sinc`), the complex 19 kHz pilot bandpass and its
     normalised phasor ``vco = p / |p|``, ``L - R = 2 (delayed m)
     Re(conj(vco)^2)`` with L+R and L-R delayed by the pilot filter's half
     length plus one, a 15 kHz lowpass on L and R;
   - NFM: the discriminator at deviation bw/2, a lowpass at bw/2;
   - AM: the magnitude, a DC block at 100 Hz, the audio AGC, a lowpass
     at bw/2;
   - USB: a translation by +bw/2, the real part, the AGC; CW: a
     translation by the 800 Hz tone, the real part, the AGC;

4. the AGC as ``core/src/dsp/loop/agc.h:70-110`` runs it, one sample at
   a time: attack when the input's magnitude is above the average, decay
   below it, gain ``min(set_point / average, max_gain)``, and where a
   sample would leave above ``max_output`` the average jumps to the
   largest magnitude in the rest of the block; it starts from an average
   of 0 (initial gain infinite).  Its coefficients are the float32
   values agc.h holds (``_attack``, ``1.0f - _attack``); the loop runs
   in float64;
5. the rational resampler to the audio rate, then for WFM the 50 us
   de-emphasis;
6. the waterfall of the wideband blocks (`wbfm.waterfall`).

Where it departs from SDR++: the normalised pilot stands where SDR++ has
a PLL; the MPX equaliser is the program's addition; the VFO has no
channel filter at its bandwidth (SDR++'s ``RxVFO`` lowpass), only the
resampler's; the DC block's and the AGC's recurrences take their
coefficients as float32 values, as SDR++'s float members hold them.

Every run starts from rest (zero filter memories, a previous
discriminator sample of 1, every oscillator at phase 0, every AGC at an
average of 0).  The program's oscillators complete whole cycles in a
block, so a run started at a block boundary has the stream's phases.
The AGC's start from rest decays over several blocks: the traffic's
``warm_blocks`` covers it.  Nothing here imports the program.

``precision="tf32"`` is the control: every operand of a product rounded
to TF32, as in `wbfm`.
"""

from __future__ import annotations

import contextlib
import struct

import numpy as np
import torch
import torch.nn.functional as F

from . import design
from .wbfm import Arith, deemphasize, discriminate, waterfall

SINGLE_STAGE_MAX_W = 2048  # the planner's bound on one polyphase stage


def _f32(v: float) -> float:
    return float(np.float32(v))


def _tf32_scalar(v: float) -> float:
    b = struct.unpack("<I", struct.pack("<f", v))[0]
    b = (b + 0x0FFF + ((b >> 13) & 1)) & 0xFFFFE000
    return struct.unpack("<f", struct.pack("<I", b & 0xFFFFFFFF))[0]


def inverse_sinc(count: int, samplerate: float,
                 f_max: float = 60000.0) -> np.ndarray:
    """The MPX equaliser: a symmetric ``count``-tap FIR whose response is
    the weighted least-squares fit of ``1 / sinc(f / fs)`` over 2 000
    frequencies up to 0.48 fs, weight 1 to ``f_max`` and 0.05 above."""
    half = (count - 1) // 2
    f = np.linspace(0.0, 0.48 * samplerate, 2000)
    target = 1.0 / np.sinc(f / samplerate)
    wgt = np.where(f <= f_max, 1.0, 0.05)
    k = np.arange(1, half + 1)
    basis = np.concatenate(
        [np.ones((len(f), 1)),
         2.0 * np.cos(2.0 * np.pi * np.outer(f / samplerate, k))], axis=1)
    coef, *_ = np.linalg.lstsq(basis * wgt[:, None], wgt * target,
                               rcond=None)
    return np.concatenate([coef[1:][::-1], coef[:1], coef[1:]])


def rational_plan(in_rate: float, out_rate: float, out_bw: float):
    """The rate change ``in_rate -> out_rate`` as ``(stages, (L, M, taps))``:
    integer decimation stages [(factor, taps)] passing ``out_bw``, then a
    polyphase L/M stage with its prototype taps (scaled by L), or None."""
    a, b = round(in_rate), round(out_rate)
    d = a // b
    while d > 1 and a % d:
        d -= 1
    bw = min(in_rate, out_rate) / 2.0
    if d > 1 and a != b:
        L1, M1 = design.rational(a, b)
        if L1 > 1:
            tpp = -(-design.tap_count(bw * 0.1, a * L1) // L1)
            if M1 + tpp <= SINGLE_STAGE_MAX_W:
                d = 1
    stages = design.decimation_plan(in_rate, d, out_bw) if d > 1 else []
    mid = a // d if d > 1 else a
    L, M = design.rational(mid, b)
    if L == M:
        return stages, None
    return stages, (L, M, design.low_pass(bw, bw * 0.1, mid * L) * L)


def polyphase(ar: Arith, a: torch.Tensor, L: int, M: int,
              taps: np.ndarray) -> torch.Tensor:
    """(..., n) -> (..., n L / M): output ``j`` is phase ``(j M) % L`` of
    the bank over the input window from ``(j M) // L``, from rest."""
    bank = design.polyphase_bank(L, taps)
    tpp = bank.shape[1]
    n = a.shape[-1]
    assert n % M == 0, (n, M)
    A = n // M
    ext = F.pad(a, (tpp - 1, 0))
    out = []
    for b in range(L):
        p, off = (b * M) % L, (b * M) // L
        out.append(ar.corr(ext[..., off:off + (A - 1) * M + tpp], bank[p], M))
    return torch.stack(out, dim=-1).reshape(a.shape[:-1] + (A * L,))


def resample(ar: Arith, x: torch.Tensor, in_rate: float, out_rate: float,
             out_bw: float) -> torch.Tensor:
    stages, poly = rational_plan(in_rate, out_rate, out_bw)
    for factor, taps in stages:
        x = ar.fir(x, taps, factor)
    if poly is not None:
        x = polyphase(ar, x, *poly)
    return x


def oscillator(n: int, hz: float, rate: float, device) -> torch.Tensor:
    """``exp(2 pi i hz k / rate)`` for k < n, its angle reduced to a turn
    in float64 before the sine."""
    k = torch.arange(n, dtype=torch.float64, device=device)
    cyc = torch.remainder(k * hz, rate) / rate
    return torch.polar(torch.ones_like(cyc), 2.0 * np.pi * cyc)


def recur(ar: Arith, x: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """``y[n] = a y[n-1] + b x[n]`` from ``y[-1] = 0``, one sample at a
    time."""
    rnd = _tf32_scalar if ar.low else float
    a, b = rnd(a), rnd(b)
    y, out = 0.0, []
    for v in ar.op(x).tolist():
        y = a * rnd(y) + b * v
        out.append(y)
    return torch.tensor(out, dtype=torch.float64, device=x.device)


def agc(ar: Arith, cfg: dict, x: torch.Tensor, rate: float,
        chunk: int) -> torch.Tensor:
    """The attack/decay AGC over the real ``x`` (n,), the clipping
    look-ahead bounded by the blocks of ``chunk`` samples the program
    hands it."""
    g = cfg["agc"]
    f32 = np.float32
    atk, dcy = f32(g["attack_hz"] / rate), f32(g["decay_hz"] / rate)
    coef = [float(f32(1) - atk), float(atk), float(f32(1) - dcy), float(dcy)]
    rnd = _tf32_scalar if ar.low else float
    one_m_atk, atk, one_m_dcy, dcy = (rnd(c) for c in coef)
    sp, max_gain, max_out = (_f32(g[k]) for k in
                             ("set_point", "max_gain", "max_output"))
    mag = x.abs()
    n = mag.shape[-1]
    assert n % chunk == 0, (n, chunk)
    rest = mag.reshape(-1, chunk).flip(-1).cummax(-1).values.flip(-1)
    ia_all, rest = ar.op(mag).tolist(), rest.reshape(-1).tolist()
    amp = sp / float(g["init_gain"])
    gains = []
    for ia, most in zip(ia_all, rest):
        gain = 1.0
        if ia != 0.0:
            r = rnd(amp)
            amp = (r * one_m_atk + ia * atk if ia > amp
                   else r * one_m_dcy + ia * dcy)
            gain = min(sp / amp, max_gain)
        if ia * rnd(gain) > max_out:
            amp = most
            gain = min(sp / amp, max_gain)
        gains.append(gain)
    gain = torch.tensor(gains, dtype=torch.float64, device=x.device)
    return ar.op(x) * ar.op(gain)


def lowpass(ar: Arith, x: torch.Tensor, cutoff: float, trans: float,
            rate: float) -> torch.Tensor:
    return ar.fir(x, design.low_pass(cutoff, trans, rate))


def wfm(ar: Arith, m: dict, y: torch.Tensor) -> torch.Tensor:
    """Complex IF (n,) -> (2, n) left and right at the IF rate."""
    rate = m["if_rate"]
    d = discriminate({"deviation": m["bandwidth_hz"] / 2.0, "if_rate": rate},
                     y)
    d = ar.fir(d, inverse_sinc(m["mpx_eq_taps"], rate))
    bp = design.band_pass_complex(m["pilot_lo_hz"], m["pilot_hi_hz"],
                                  m["pilot_trans_hz"], rate, odd=True)
    p = torch.complex(ar.fir(d, bp.real.copy()), ar.fir(d, bp.imag.copy()))
    mag = p.abs()
    vco = torch.where(mag > 1e-12, p / torch.clamp(mag, min=1e-12),
                      torch.ones_like(p))
    vr, vi = ar.op(vco.real), ar.op(vco.imag)
    c2 = vr * vr - vi * vi
    delay = (len(bp) - 1) // 2 + 1
    lpr = F.pad(d, (delay, 0))[..., :d.shape[-1]]
    lmr = 2.0 * ar.op(lpr) * ar.op(c2)
    stereo = torch.stack([lpr + lmr, lpr - lmr])
    return lowpass(ar, stereo, m["audio_bw_hz"], m["audio_trans_hz"], rate)


def radio(ar: Arith, cfg: dict, mode: str, y: torch.Tensor,
          chunk: int) -> torch.Tensor:
    """One VFO's IF (n,) -> (2, n_audio) at the audio rate."""
    m = cfg["modes"][mode]
    rate, bw = m["if_rate"], m["bandwidth_hz"]
    if mode == "wfm":
        a = wfm(ar, m, y)
    elif mode == "nfm":
        d = discriminate({"deviation": bw / 2.0, "if_rate": rate}, y)
        a = lowpass(ar, d, bw / 2.0, bw * 0.05, rate)
    elif mode == "am":
        r = _f32(m["dc_block_hz"] / rate)
        mag = y.abs()
        prev = F.pad(recur(ar, mag, _f32(np.float32(1) - np.float32(r)), r),
                     (1, 0))[:-1]
        a = agc(ar, cfg, mag - prev, rate, chunk)
        a = lowpass(ar, a, bw / 2.0, bw * 0.05, rate)
    else:  # usb, cw: translate, real part, AGC
        osc = oscillator(y.shape[-1], m["translate_hz"], rate, y.device)
        a = agc(ar, cfg, (ar.op(y) * ar.op(osc)).real, rate, chunk)
    if a.ndim == 1:
        a = torch.stack([a, a])
    audio_rate = float(cfg["audio_rate"])
    a = resample(ar, a, rate, audio_rate, 0.4 * audio_rate)
    if m.get("deemphasis_s"):
        a = deemphasize(ar, {"audio_rate": audio_rate,
                             "deemphasis_s": m["deemphasis_s"]}, a)
    return a


def ddc(ar: Arith, cfg: dict, x: torch.Tensor, offset_hz: float,
        if_rate: float) -> torch.Tensor:
    """Wideband (n,) -> the VFO's complex IF at ``if_rate``."""
    fs = float(cfg["samplerate"])
    lo = oscillator(x.shape[-1], -offset_hz, fs, x.device)
    return resample(ar, ar.op(x) * ar.op(lo), fs, if_rate, 0.4 * if_rate)


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for matmuls and convolutions, as the configuration states
    (the reference computes in float64, which TF32 never touches); the
    caller's settings restored."""
    mm, conv = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = conv


def run(cfg: dict, blocks: torch.Tensor, precision: str = "f64") -> dict:
    """``blocks`` (k, block_len) complex, consecutive, from rest ->
    ``{"audio.<vfo>": (k, 2, n_audio), "spec": (k, frames, fft_size)}``,
    float64, on ``blocks``' device."""
    with _no_tf32():
        return _run(Arith(precision), cfg, blocks)


def _run(ar: Arith, cfg: dict, blocks: torch.Tensor) -> dict:
    k, n = blocks.shape
    fs = float(cfg["samplerate"])
    x = blocks.reshape(-1).to(torch.complex128)
    out = {}
    for vfo in cfg["vfos"]:
        rate = cfg["modes"][vfo["mode"]]["if_rate"]
        chunk = round(n * rate / fs)
        y = ddc(ar, cfg, x, float(vfo["offset_hz"]), rate)
        a = radio(ar, cfg, vfo["mode"], y, chunk)
        out[f"audio.{vfo['name']}"] = a.reshape(2, k, -1).movedim(1, 0)
        del y, a
    spec = waterfall(ar, cfg, x)
    out["spec"] = spec.reshape(k, -1, spec.shape[-1])
    return out


def gaps(cfg: dict, got: dict, want: dict) -> dict:
    """The numbers compared, over the blocks given (``got`` the program's
    float32 outputs, ``want`` the reference's):

    - ``audio_gap``: the largest absolute difference of any audio sample
      of a VFO whose mode has no AGC (WFM, NFM; full scale is 1);
    - ``agc_audio_gap``: of the VFOs whose mode has an AGC (AM, USB,
      CW), the largest absolute difference over the reference's peak
      magnitude, each VFO on its own;
    - ``waterfall_gap_db``: the largest difference in dB of any waterfall
      bin within 80 dB of its frame's peak."""
    out = {"audio_gap": 0.0, "agc_audio_gap": 0.0}
    for vfo in cfg["vfos"]:
        name = f"audio.{vfo['name']}"
        ref = want[name]
        gap = (got[name].to(ref.device, torch.float64) - ref).abs().max()
        if cfg["modes"][vfo["mode"]].get("agc"):
            out["agc_audio_gap"] = max(out["agc_audio_gap"],
                                       float(gap / ref.abs().max()))
        else:
            out["audio_gap"] = max(out["audio_gap"], float(gap))
    ref = want["spec"]
    live = ref > ref.amax(dim=-1, keepdim=True) - 80.0
    spec = (got["spec"].to(ref.device, torch.float64) - ref).abs()[live]
    out["waterfall_gap_db"] = float(spec.max())
    return out
